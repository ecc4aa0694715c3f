"""fadtk-equivalent FAD engine and embedding loaders (port of
`diffmusic_tpu/fadtk`: the engine, the cache layout, the stats helpers and
the `mfcc-stack` and `vggish` loaders)."""

from .engine import FADEngine, cache_embedding_files, cache_path
from .model_loader import ModelLoader, get_all_models, get_model
from .utils import merge_stats, stats_from_npy_dir

__all__ = ["FADEngine", "cache_embedding_files", "cache_path", "ModelLoader",
           "get_all_models", "get_model", "merge_stats", "stats_from_npy_dir"]

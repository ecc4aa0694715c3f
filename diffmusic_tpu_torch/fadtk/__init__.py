"""fadtk-equivalent FAD engine and embedding loaders (port of
`diffmusic_tpu/fadtk`: the engine, the cache layout, the stats helpers, the
embedder registry, and the command lines
`python -m diffmusic_tpu_torch.fadtk`, `.fadtk.embeds`, `.fadtk.package`
and `.fadtk.test`)."""

from .engine import FADEngine, cache_embedding_files, cache_path, make_engine
from .model_loader import ModelLoader, get_all_models, get_model
from .utils import merge_stats, stats_from_npy_dir

__all__ = ["FADEngine", "cache_embedding_files", "cache_path", "make_engine", "ModelLoader",
           "get_all_models", "get_model", "merge_stats", "stats_from_npy_dir"]

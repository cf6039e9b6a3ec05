from ddls_tpu_torch.utils.common import (SqliteDict, Stopwatch,
                                         get_class_from_path,
                                         recursive_update, seed_everything,
                                         unique_experiment_dir)

__all__ = ["SqliteDict", "Stopwatch", "get_class_from_path",
           "recursive_update", "seed_everything", "unique_experiment_dir"]

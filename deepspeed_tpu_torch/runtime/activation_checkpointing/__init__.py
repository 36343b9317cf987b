from . import checkpointing
from .checkpointing import (checkpoint, checkpoint_wrapper, configure,
                            get_rng_tracker, is_configured,
                            model_parallel_seed,
                            partition_activations_in_checkpoint, reset,
                            set_num_layers, set_remat_policy)

__all__ = ["checkpointing", "checkpoint", "checkpoint_wrapper", "configure",
           "get_rng_tracker", "is_configured", "model_parallel_seed",
           "partition_activations_in_checkpoint", "reset", "set_num_layers",
           "set_remat_policy"]

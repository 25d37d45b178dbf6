from tts_tpu_torch.parallel.data_parallel import (make_dp_train_step,
                                                  make_glow_dp_train_step,
                                                  replicate, unreplicate)
from tts_tpu_torch.parallel.mesh import (initialize_multihost, is_primary,
                                         local_batch_slice, make_mesh)

__all__ = ["make_mesh", "local_batch_slice", "is_primary",
           "initialize_multihost", "make_dp_train_step",
           "make_glow_dp_train_step", "replicate", "unreplicate"]

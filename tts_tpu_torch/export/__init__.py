from tts_tpu_torch.export.deploy import (export_program, load_program,
                                         max_abs_diff, run_program)

__all__ = ["export_program", "load_program", "max_abs_diff", "run_program"]

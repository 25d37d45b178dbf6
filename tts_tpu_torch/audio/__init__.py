from tts_tpu_torch.audio.processor import AudioProcessor
from tts_tpu_torch.audio import mel

__all__ = ["AudioProcessor", "mel"]

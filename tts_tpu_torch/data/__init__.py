from tts_tpu_torch.data.formatters import get_formatter_by_name, load_meta_data
from tts_tpu_torch.data.tts_dataset import TTSDataset

__all__ = ["load_meta_data", "get_formatter_by_name", "TTSDataset"]

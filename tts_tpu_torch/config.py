"""Config system: commented-JSON loading, attribute-dict access, schema validation.

Capability parity with the reference config layer
(Mozilla TTS's TTS/utils/io.py:12-35 `load_config`,
Mozilla TTS's TTS/utils/generic_utils.py:139-160 `check_argument`,
Mozilla TTS's TTS/tts/utils/generic_utils.py:137-260 `check_config_tts`),
re-designed: same accepted file format (JSON with ``//`` comments) so reference
config files keep working, plus typed accessors used by the jitted trainers.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional


class AttrDict(dict):
    """dict with attribute access, recursively applied to nested dicts."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in self.items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, _wrap(value))

    def copy(self) -> "AttrDict":
        return AttrDict({k: v for k, v in self.items()})


def _wrap(v: Any) -> Any:
    if isinstance(v, AttrDict):
        return v
    if isinstance(v, dict):
        return AttrDict(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


_COMMENT_RE = re.compile(r'("(?:[^"\\]|\\.)*")|(//[^\n]*)')


def strip_json_comments(text: str) -> str:
    """Remove ``//`` line comments outside of string literals."""

    def repl(m: re.Match) -> str:
        if m.group(1) is not None:
            return m.group(1)
        return ""

    return _COMMENT_RE.sub(repl, text)


def loads_config(text: str) -> AttrDict:
    return AttrDict(json.loads(strip_json_comments(text)))


def load_config(path: str) -> AttrDict:
    """Load a JSON config file, tolerating ``//`` comments (reference format)."""
    with open(path, "r", encoding="utf-8") as f:
        return loads_config(f.read())


def save_config(cfg: Dict[str, Any], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=2, default=str)


# ---------------------------------------------------------------------------
# Schema validation
# ---------------------------------------------------------------------------

def check_argument(
    name: str,
    c: Dict[str, Any],
    *,
    is_path: bool = False,
    prerequest: Optional[Any] = None,
    enum_list: Optional[List[Any]] = None,
    max_val: Optional[float] = None,
    min_val: Optional[float] = None,
    restricted: bool = False,
    val_type: Any = None,
    alternative: Optional[str] = None,
) -> None:
    """Validate a single config entry: presence / type / range / enum.

    Same rule surface as the reference validator
    (Mozilla TTS's TTS/utils/generic_utils.py:139-160).
    """
    if alternative is not None and alternative in c and c[alternative] is not None:
        return
    prereqs = prerequest if isinstance(prerequest, list) else ([prerequest] if prerequest else [])
    for p in prereqs:
        if p not in c or c[p] in (None, False):
            return  # prerequisite disabled -> argument optional
    if restricted:
        assert name in c, f"config: '{name}' is required"
    if name not in c or c[name] is None:
        return
    v = c[name]
    if val_type is not None:
        types = val_type if isinstance(val_type, (tuple, list)) else (val_type,)
        ok = any(isinstance(v, t) for t in types)
        # bool is an int subclass in python; reject bools for numeric fields
        if isinstance(v, bool) and bool not in types:
            ok = False
        if int in types and isinstance(v, float) and float not in types:
            ok = v == int(v)
        assert ok, f"config: '{name}' must be {val_type}, got {type(v).__name__}"
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        if max_val is not None:
            assert v <= max_val, f"config: '{name}'={v} exceeds max {max_val}"
        if min_val is not None:
            assert v >= min_val, f"config: '{name}'={v} below min {min_val}"
    if enum_list is not None:
        assert str(v).lower() in enum_list, f"config: '{name}'={v} not in {enum_list}"


def check_config_audio(c: Dict[str, Any]) -> None:
    audio = c.get("audio", {})
    check_argument("sample_rate", audio, restricted=True, val_type=int, min_val=512)
    check_argument("num_mels", audio, restricted=True, val_type=int, min_val=10, max_val=2056)
    check_argument("fft_size", audio, restricted=True, val_type=int, min_val=128, max_val=4058)
    check_argument("hop_length", audio, restricted=True, val_type=int, min_val=1)
    check_argument("win_length", audio, restricted=True, val_type=int, min_val=32)
    check_argument("preemphasis", audio, restricted=True, val_type=float, min_val=0, max_val=1)
    check_argument("min_level_db", audio, restricted=True, val_type=int, min_val=-1000, max_val=10)
    check_argument("ref_level_db", audio, restricted=True, val_type=int, min_val=0, max_val=1000)
    check_argument("power", audio, restricted=True, val_type=float, min_val=1, max_val=5)
    check_argument("griffin_lim_iters", audio, restricted=True, val_type=int, min_val=10, max_val=1000)
    check_argument("signal_norm", audio, restricted=True, val_type=bool)
    check_argument("symmetric_norm", audio, restricted=True, val_type=bool)
    check_argument("max_norm", audio, restricted=True, val_type=float, min_val=0.1, max_val=1000)
    check_argument("clip_norm", audio, restricted=True, val_type=bool)
    check_argument("mel_fmin", audio, restricted=True, val_type=float, min_val=0.0, max_val=1000)
    check_argument("mel_fmax", audio, restricted=True, val_type=float, min_val=500.0)
    check_argument("do_trim_silence", audio, restricted=True, val_type=bool)


def check_config_tts(c: Dict[str, Any]) -> None:
    """Full-schema validation for TTS training configs.

    Mirrors the coverage of Mozilla TTS's TTS/tts/utils/generic_utils.py:137-260.
    """
    check_argument("model", c, restricted=True, val_type=str,
                   enum_list=["tacotron", "tacotron2", "glow_tts"])
    check_argument("run_name", c, restricted=True, val_type=str)
    check_config_audio(c)

    # training
    check_argument("batch_size", c, restricted=True, val_type=int, min_val=1)
    check_argument("eval_batch_size", c, restricted=True, val_type=int, min_val=1)
    check_argument("r", c, restricted=True, val_type=int, min_val=1)
    check_argument("gradual_training", c, restricted=False, val_type=list)
    check_argument("mixed_precision", c, restricted=False, val_type=bool)

    # loss
    check_argument("loss_masking", c, restricted=True, val_type=bool)
    check_argument("decoder_loss_alpha", c, restricted=False, val_type=float, min_val=0)
    check_argument("postnet_loss_alpha", c, restricted=False, val_type=float, min_val=0)
    check_argument("ga_alpha", c, restricted=False, val_type=float, min_val=0)

    # validation / logging
    check_argument("run_eval", c, restricted=True, val_type=bool)
    check_argument("test_delay_epochs", c, restricted=True, val_type=int, min_val=0)
    check_argument("print_step", c, restricted=True, val_type=int, min_val=1)
    check_argument("save_step", c, restricted=True, val_type=int, min_val=1)
    check_argument("checkpoint", c, restricted=True, val_type=bool)

    # optimizer
    check_argument("noam_schedule", c, restricted=False, val_type=bool)
    check_argument("grad_clip", c, restricted=True, val_type=(float, int), min_val=0.0)
    check_argument("epochs", c, restricted=True, val_type=int, min_val=1)
    check_argument("lr", c, restricted=True, val_type=float, min_val=0)
    check_argument("wd", c, restricted=False, val_type=float, min_val=0)
    check_argument("warmup_steps", c, restricted=False, val_type=int, min_val=0)
    check_argument("seq_len_norm", c, restricted=True, val_type=bool)

    # tacotron
    check_argument("memory_size", c, restricted=False, val_type=int, min_val=-1)
    check_argument("attention_type", c, restricted=False, val_type=str,
                   enum_list=["graves", "original"])
    check_argument("attention_norm", c, restricted=False, val_type=str,
                   enum_list=["sigmoid", "softmax"])
    check_argument("prenet_type", c, restricted=False, val_type=str,
                   enum_list=["original", "bn"])
    check_argument("prenet_dropout", c, restricted=False, val_type=bool)
    check_argument("windowing", c, restricted=False, val_type=bool)
    check_argument("use_forward_attn", c, restricted=False, val_type=bool)
    check_argument("forward_attn_mask", c, restricted=False, val_type=bool)
    check_argument("transition_agent", c, restricted=False, val_type=bool)
    check_argument("location_attn", c, restricted=False, val_type=bool)
    check_argument("bidirectional_decoder", c, restricted=False, val_type=bool)
    check_argument("double_decoder_consistency", c, restricted=False, val_type=bool)
    check_argument("ddc_r", c, restricted=False, val_type=int, min_val=1,
                   prerequest="double_decoder_consistency")
    check_argument("stopnet", c, restricted=False, val_type=bool)
    check_argument("separate_stopnet", c, restricted=False, val_type=bool)

    # dataset
    check_argument("datasets", c, restricted=True, val_type=list)
    check_argument("min_seq_len", c, restricted=False, val_type=int, min_val=0)
    check_argument("max_seq_len", c, restricted=False, val_type=int, min_val=10)
    check_argument("batch_group_size", c, restricted=False, val_type=int, min_val=0)
    check_argument("num_loader_workers", c, restricted=False, val_type=int, min_val=0)
    check_argument("output_path", c, restricted=True, val_type=str)

    # multi-speaker / GST
    check_argument("use_speaker_embedding", c, restricted=False, val_type=bool)
    check_argument("use_external_speaker_embedding_file", c, restricted=False,
                   val_type=bool, prerequest="use_speaker_embedding")
    check_argument("use_gst", c, restricted=False, val_type=bool)
    if c.get("use_gst"):
        check_argument("gst", c, restricted=True, val_type=dict)

    # text processing
    check_argument("text_cleaner", c, restricted=False, val_type=str)
    check_argument("use_phonemes", c, restricted=False, val_type=bool)
    check_argument("phoneme_language", c, restricted=False, val_type=str,
                   prerequest="use_phonemes")
    check_argument("enable_eos_bos_chars", c, restricted=False, val_type=bool)


def check_config_vocoder(c: Dict[str, Any]) -> None:
    check_argument("run_name", c, restricted=True, val_type=str)
    check_config_audio(c)
    check_argument("generator_model", c, restricted=True, val_type=str)
    check_argument("discriminator_model", c, restricted=True, val_type=str)
    check_argument("batch_size", c, restricted=True, val_type=int, min_val=1)
    check_argument("seq_len", c, restricted=True, val_type=int, min_val=256)
    check_argument("epochs", c, restricted=True, val_type=int, min_val=1)
    check_argument("data_path", c, restricted=False, val_type=str)
    check_argument("output_path", c, restricted=True, val_type=str)
    check_argument("steps_to_start_discriminator", c, restricted=False, val_type=int, min_val=0)


def check_config_speaker_encoder(c: Dict[str, Any]) -> None:
    check_argument("run_name", c, restricted=True, val_type=str)
    check_config_audio(c)
    check_argument("num_speakers_in_batch", c, restricted=True, val_type=int, min_val=1)
    check_argument("num_utters_per_speaker", c, restricted=True, val_type=int, min_val=1)
    check_argument("loss", c, restricted=True, val_type=str,
                   enum_list=["ge2e", "angleproto"])
    check_argument("model", c, restricted=True, val_type=dict)
    check_argument("datasets", c, restricted=True, val_type=list)

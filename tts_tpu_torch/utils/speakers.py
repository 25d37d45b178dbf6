"""speakers.json IO (≙ tts_tpu/utils/speakers.py; its speaker list is
``data/formatters.py::get_speakers``)."""

from __future__ import annotations

import json
import os
from typing import Dict


def make_speakers_json_path(out_path: str) -> str:
    return os.path.join(out_path, "speakers.json")


def load_speaker_mapping(out_path: str) -> Dict:
    if os.path.splitext(out_path)[1] == ".json":
        json_file = out_path
    else:
        json_file = make_speakers_json_path(out_path)
    try:
        with open(json_file) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def save_speaker_mapping(out_path: str, speaker_mapping: Dict) -> None:
    speakers_json_path = make_speakers_json_path(out_path)
    with open(speakers_json_path, "w") as f:
        json.dump(speaker_mapping, f, indent=4)


"""Dataset formatters: metadata-file parsers for the public TTS corpora
(≙ tts_tpu/data/formatters.py, a copy).

Capability parity with Mozilla TTS's TTS/tts/datasets/preprocess.py (17
formatters + ``load_meta_data`` multi-dataset merge with train/eval split).
Each formatter returns ``[[text, wav_path, speaker_name], ...]``.
"""

from __future__ import annotations

import glob
import os
import random
import re
import sys
from typing import Callable, List, Optional, Sequence, Tuple

Item = List[str]  # [text, wav_file, speaker_name]


def load_meta_data(datasets: Sequence[dict], eval_split_size: float = 0.01,
                   ) -> Tuple[List[Item], List[Item]]:
    """Merge multiple dataset configs into train/eval item lists
    (≙ preprocess.py:10-35)."""
    meta_train: List[Item] = []
    meta_eval: List[Item] = []
    for ds in datasets:
        name = ds["name"]
        root = ds["path"]
        meta_train_file = ds.get("meta_file_train")
        meta_eval_file = ds.get("meta_file_val")
        formatter = get_formatter_by_name(name)
        train_items = formatter(root, meta_train_file)
        if meta_eval_file:
            eval_items = formatter(root, meta_eval_file)
        else:
            eval_items, train_items = split_dataset(train_items, eval_split_size)
        meta_train += train_items
        meta_eval += eval_items
    return meta_train, meta_eval


def split_dataset(items: List[Item], eval_split_size: float = 0.01,
                  ) -> Tuple[List[Item], List[Item]]:
    """Speaker-aware eval split (≙ TTS/tts/utils/generic_utils.py:11-29)."""
    speakers = [it[-1] for it in items]
    is_multi_speaker = len(set(speakers)) > 1
    n_eval = int(len(items) * eval_split_size)
    n_eval = max(min(n_eval, 500), 1)
    rng = random.Random(0)
    items = list(items)
    rng.shuffle(items)
    if is_multi_speaker:
        eval_items: List[Item] = []
        rest: List[Item] = []
        seen = set()
        for it in items:
            if len(eval_items) < n_eval and it[-1] not in seen:
                eval_items.append(it)
                seen.add(it[-1])
            else:
                rest.append(it)
        # top up from remaining if too few speakers
        while len(eval_items) < n_eval and rest:
            eval_items.append(rest.pop())
        return eval_items, rest
    return items[:n_eval], items[n_eval:]


# ---------------------------------------------------------------------------
# formatters
# ---------------------------------------------------------------------------

def ljspeech(root: str, meta_file: str) -> List[Item]:
    """LJSpeech metadata.csv: id|raw_text|normalized_text."""
    items = []
    with open(os.path.join(root, meta_file), encoding="utf-8") as f:
        for line in f:
            cols = line.strip().split("|")
            if len(cols) < 2:
                continue
            wav = os.path.join(root, "wavs", cols[0] + ".wav")
            text = cols[2] if len(cols) > 2 else cols[1]
            items.append([text, wav, "ljspeech"])
    return items


def tweb(root: str, meta_file: str) -> List[Item]:
    """The World English Bible: tab-separated id\ttext."""
    items = []
    with open(os.path.join(root, meta_file), encoding="utf-8") as f:
        for line in f:
            cols = line.strip().split("\t")
            if len(cols) < 2:
                continue
            wav = os.path.join(root, cols[0] + ".wav")
            items.append([cols[1], wav, "tweb"])
    return items


def mozilla(root: str, meta_file: str) -> List[Item]:
    """Mozilla corpus: batch_dir|wav_name|text variants."""
    items = []
    with open(os.path.join(root, meta_file), encoding="utf-8") as f:
        for line in f:
            cols = line.strip().split("|")
            if len(cols) < 2:
                continue
            wav = os.path.join(root, "wavs", cols[1])
            items.append([cols[0], wav, "mozilla"])
    return items


def mozilla_de(root: str, meta_file: str) -> List[Item]:
    items = []
    with open(os.path.join(root, meta_file), encoding="iso-8859-1") as f:
        for line in f:
            cols = line.strip().split("|")
            if len(cols) < 2:
                continue
            batch, wav_name = cols[1].strip().split("_", 1)
            wav = os.path.join(root, f"BATCH_{batch}_FINAL", wav_name)
            items.append([cols[0], wav, "mozilla_de"])
    return items


def mailabs(root: str, meta_files: Optional[str] = None) -> List[Item]:
    """M-AILABS directory walk: .../by_book/<gender>/<speaker>/<book>/metadata.csv."""
    if meta_files is None:
        csv_files = glob.glob(os.path.join(root, "**", "metadata.csv"), recursive=True)
    else:
        csv_files = [os.path.join(root, m) for m in meta_files.split(",")]
    speaker_re = re.compile(r"by_book[/\\](male|female)[/\\](?P<speaker>[^/\\]+)")
    items = []
    for csv_file in sorted(csv_files):
        folder = os.path.dirname(csv_file)
        m = speaker_re.search(csv_file)
        speaker = m.group("speaker") if m else "mailabs"
        with open(csv_file, encoding="utf-8") as f:
            for line in f:
                cols = line.strip().split("|")
                if len(cols) < 2:
                    continue
                wav = os.path.join(folder, "wavs", cols[0] + ".wav")
                if os.path.isfile(wav):
                    text = cols[2] if len(cols) > 2 else cols[1]
                    items.append([text, wav, speaker])
    return items


def nancy(root: str, meta_file: str) -> List[Item]:
    """Nancy (Blizzard 2011): lines like `text ( id "utterance" )`."""
    items = []
    with open(os.path.join(root, meta_file), encoding="utf-8") as f:
        for line in f:
            utt_id = line.split()[1]
            text = line[line.find('"') + 1: line.rfind('"') - 1]
            wav = os.path.join(root, "wavn", utt_id + ".wav")
            items.append([text, wav, "nancy"])
    return items


def common_voice(root: str, meta_file: str) -> List[Item]:
    """Mozilla Common Voice .tsv format."""
    items = []
    with open(os.path.join(root, meta_file), encoding="utf-8") as f:
        for line in f:
            if line.startswith("client_id"):
                continue
            cols = line.split("\t")
            if len(cols) < 3:
                continue
            wav = os.path.join(root, "clips", cols[1].replace(".mp3", ".wav"))
            items.append([cols[2], wav, "MCV_" + cols[0]])
    return items


def libri_tts(root: str, meta_files: Optional[str] = None) -> List[Item]:
    """LibriTTS: walk for *trans.tsv files (id\toriginal\tnormalized)."""
    items = []
    if meta_files is None:
        files = glob.glob(f"{root}/**/*trans.tsv", recursive=True)
    else:
        files = [os.path.join(root, m) for m in meta_files.split(",")]
    for meta_file in sorted(files):
        folder = os.path.dirname(meta_file)
        with open(meta_file, encoding="utf-8") as f:
            for line in f:
                cols = line.split("\t")
                if len(cols) < 2:
                    continue
                utt_id = cols[0]
                speaker = utt_id.split("_")[0]
                wav = os.path.join(folder, utt_id + ".wav")
                text = cols[2].strip() if len(cols) > 2 else cols[1].strip()
                items.append([text, wav, f"LTTS_{speaker}"])
    return items


def custom_turkish(root: str, meta_file: str) -> List[Item]:
    items, skipped = [], []
    with open(os.path.join(root, meta_file), encoding="utf-8") as f:
        for line in f:
            cols = line.strip().split("|")
            if len(cols) < 2:
                continue
            wav = os.path.join(root, "wavs", cols[0].strip() + ".wav")
            if not os.path.exists(wav):
                skipped.append(wav)
                continue
            items.append([cols[1].strip(), wav, "turkish-female"])
    if skipped:
        print(f" [!] {len(skipped)} files skipped (not found)", file=sys.stderr)
    return items


def brspeech(root: str, meta_file: str) -> List[Item]:
    """BRSpeech 3.0 beta: wav_path|text|...|speaker_id."""
    items = []
    with open(os.path.join(root, meta_file), encoding="utf-8") as f:
        for line in f:
            if line.startswith("wav_filename"):
                continue
            cols = line.strip().split("|")
            if len(cols) < 3:
                continue
            items.append([cols[2], os.path.join(root, cols[0]), cols[3] if len(cols) > 3 else "brspeech"])
    return items


def vctk(root: str, meta_files=None, wavs_path: str = "wav48") -> List[Item]:
    """VCTK: txt/<speaker>/<id>.txt + wav48/<speaker>/<id>.wav."""
    items = []
    for txt_file in sorted(glob.glob(f"{root}/txt/**/*.txt", recursive=True)):
        speaker = os.path.basename(os.path.dirname(txt_file))
        utt_id = os.path.splitext(os.path.basename(txt_file))[0]
        with open(txt_file, encoding="utf-8") as f:
            text = f.read().strip()
        wav = os.path.join(root, wavs_path, speaker, utt_id + ".wav")
        items.append([text, wav, "VCTK_" + speaker])
    return items


def vctk_slim(root: str, meta_files=None, wavs_path: str = "wav48") -> List[Item]:
    """VCTK without reading transcripts (speaker-encoder use)."""
    items = []
    for wav in sorted(glob.glob(f"{root}/{wavs_path}/**/*.wav", recursive=True)):
        speaker = os.path.basename(os.path.dirname(wav))
        items.append([None, wav, "VCTK_" + speaker])
    return items


def voxceleb1(root: str, meta_file=None) -> List[Item]:
    return _voxceleb(root, voxceleb_idx=1)


def voxceleb2(root: str, meta_file=None) -> List[Item]:
    return _voxceleb(root, voxceleb_idx=2)


def _voxceleb(root: str, voxceleb_idx: int) -> List[Item]:
    items = []
    for wav in sorted(glob.glob(f"{root}/**/*.wav", recursive=True)):
        speaker = next((p for p in wav.split(os.sep) if p.startswith("id")), "unk")
        items.append([None, wav, f"voxceleb{voxceleb_idx}_{speaker}"])
    return items


FORMATTERS: dict = {
    "ljspeech": ljspeech,
    "tweb": tweb,
    "mozilla": mozilla,
    "mozilla_de": mozilla_de,
    "mailabs": mailabs,
    "nancy": nancy,
    "common_voice": common_voice,
    "libri_tts": libri_tts,
    "custom_turkish": custom_turkish,
    "brspeech": brspeech,
    "vctk": vctk,
    "vctk_slim": vctk_slim,
    "voxceleb1": voxceleb1,
    "voxceleb2": voxceleb2,
}


def get_formatter_by_name(name: str) -> Callable:
    if name not in FORMATTERS:
        raise KeyError(f"unknown dataset formatter: {name}")
    return FORMATTERS[name]


def get_speakers(items: Sequence[Item]) -> List[str]:
    """Sorted unique speaker names (≙ TTS/tts/utils/speakers.py get_speakers)."""
    return sorted({it[-1] for it in items})

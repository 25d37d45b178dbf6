"""VoxCeleb 1 & 2 download and preparation for speaker-encoder training
(≙ tts_tpu/bin/prepare_voxceleb.py, a copy: the standard library and the
port's wav reader only). The pipeline per subset:

  1. download every part or zip (multi-part subsets ship as ``_partaa..``
     chunks; VoxCeleb needs registered credentials: HTTP basic auth);
  2. concatenate the parts into one zip and verify its md5;
  3. extract;
  4. walk the tree: keep ``.wav``; decode ``.m4a`` (VoxCeleb2) to wav with
     ffmpeg; dense speaker ids in first-seen order;
  5. write ``<subset>.csv``, tab-separated (wav_filename, wav_length_ms,
     speaker_id, speaker_name).

Steps 2-5 are plain Python and tested offline on temporary files; step 1
is the only one that reaches the network.

Usage:
    python -m tts_tpu_torch.bin.prepare_voxceleb <save_dir> <user> \
        <password> [--subsets vox1_dev_wav vox1_test_wav]
"""

from __future__ import annotations

import argparse
import base64
import csv
import hashlib
import os
import shutil
import subprocess
import zipfile
from typing import Dict, List, Optional, Sequence, Tuple

_BASE = "https://www.robots.ox.ac.uk/~vgg/data/voxceleb/vox1a"

SUBSETS: Dict[str, List[str]] = {
    "vox1_dev_wav": [f"{_BASE}/vox1_dev_wav_part{p}" for p in "aa ab ac ad".split()],
    "vox1_test_wav": [f"{_BASE}/vox1_test_wav.zip"],
    "vox2_dev_aac": [f"{_BASE}/vox2_dev_aac_part{p}"
                     for p in "aa ab ac ad ae af ag ah".split()],
    "vox2_test_aac": [f"{_BASE}/vox2_test_aac.zip"],
}

MD5SUM = {
    "vox1_dev_wav": "ae63e55b951748cc486645f532ba230b",
    "vox2_dev_aac": "bbc063c46078a602ca71605645c2a402",
    "vox1_test_wav": "185fdc63c3c739954633d50379a3d102",
    "vox2_test_aac": "0d2b3ea430a821c33263b5ea37ede312",
}

CSV_COLUMNS = ("wav_filename", "wav_length_ms", "speaker_id", "speaker_name")


def download_parts(directory: str, urls: Sequence[str], user: str,
                   password: str) -> List[str]:
    """Fetch each url into ``directory`` (skipping existing files) with
    HTTP basic auth. Returns the local paths in url order."""
    import urllib.request

    os.makedirs(directory, exist_ok=True)
    paths = []
    auth = base64.b64encode(f"{user}:{password}".encode()).decode()
    for url in urls:
        dst = os.path.join(directory, url.split("/")[-1])
        paths.append(dst)
        if os.path.exists(dst):
            continue
        req = urllib.request.Request(url,
                                     headers={"Authorization": f"Basic {auth}"})
        with urllib.request.urlopen(req) as r, open(dst + ".tmp", "wb") as f:
            shutil.copyfileobj(r, f)
        os.replace(dst + ".tmp", dst)
    return paths


def concatenate_parts(part_paths: Sequence[str], zip_path: str) -> str:
    """Join multi-part downloads into one zip (≙ ``cat part* > x.zip``).
    A single already-``.zip`` input is passed through untouched."""
    if len(part_paths) == 1 and part_paths[0].endswith(".zip"):
        return part_paths[0]
    with open(zip_path, "wb") as out:
        for p in sorted(part_paths):
            with open(p, "rb") as f:
                shutil.copyfileobj(f, out)
    return zip_path


def verify_md5(path: str, expected: str) -> None:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    if h.hexdigest() != expected:
        raise ValueError(f"md5sum of {path} mismatch: "
                         f"{h.hexdigest()} != {expected}")


def extract_zip(zip_path: str, directory: str, subset: str) -> str:
    """Extract and rename the archive's top-level folder to ``subset``."""
    with zipfile.ZipFile(zip_path, "r") as zf:
        zf.extractall(directory)
        top = zf.infolist()[0].filename.split("/")[0]
    src = os.path.join(directory, top)
    dst = os.path.join(directory, subset)
    if os.path.abspath(src) != os.path.abspath(dst):
        os.replace(src, dst)
    return dst


def decode_aac_with_ffmpeg(aac_file: str, wav_file: str) -> bool:
    ret = subprocess.call(["ffmpeg", "-i", aac_file, wav_file],
                          stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL)
    return ret == 0


def _wav_length(path: str) -> int:
    from tts_tpu_torch.audio.processor import read_wav
    data, _ = read_wav(path)
    return len(data)


def convert_audio_and_make_label(input_dir: str, subset: str,
                                 output_dir: str, output_file: str,
                                 speaker_id_dict: Optional[Dict[str, int]]
                                 = None) -> str:
    """Walk ``input_dir/subset``; decode .m4a; emit the reference's
    tab-separated csv. ``speaker_id_dict`` carries dense first-seen speaker
    ids ACROSS subsets when shared (the reference uses one global dict)."""
    if speaker_id_dict is None:
        speaker_id_dict = {}
    source_dir = os.path.join(input_dir, subset)
    rows: List[Tuple[str, int, int, str]] = []
    for root, _, filenames in sorted(os.walk(source_dir)):
        for filename in sorted(filenames):
            name, ext = os.path.splitext(filename)
            if ext.lower() == ".wav":
                # skip already-converted "<x>.m4a.wav" doubles when the
                # m4a is rescanned (reference skips double extensions)
                if os.path.splitext(name)[1]:
                    continue
                wav_file = os.path.join(root, filename)
            elif ext.lower() == ".m4a":
                aac_file = os.path.join(root, filename)
                wav_file = aac_file + ".wav"
                if not os.path.exists(wav_file):
                    if not decode_aac_with_ffmpeg(aac_file, wav_file):
                        raise RuntimeError(
                            f"Audio decoding failed for {aac_file}; "
                            f"check the ffmpeg installation")
            else:
                continue
            speaker_name = root.split(os.path.sep)[-2]
            if speaker_name not in speaker_id_dict:
                speaker_id_dict[speaker_name] = len(speaker_id_dict)
            rows.append((os.path.abspath(wav_file), _wav_length(wav_file),
                         speaker_id_dict[speaker_name], speaker_name))

    csv_path = os.path.join(output_dir, output_file)
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(CSV_COLUMNS)
        w.writerows(rows)
    return csv_path


def processor(directory: str, subset: str, user: str = "", password: str = "",
              force_process: bool = False,
              speaker_id_dict: Optional[Dict[str, int]] = None) -> str:
    """Download (if needed) + process one subset; returns the csv path."""
    if subset not in SUBSETS:
        raise ValueError(f"{subset} is not in voxceleb")
    subset_csv = os.path.join(directory, subset + ".csv")
    if not force_process and os.path.exists(subset_csv):
        # replay the cached csv's speaker ids into the shared dict so a
        # LATER subset in a resumed run keeps dense non-colliding ids
        if speaker_id_dict is not None:
            with open(subset_csv, newline="") as f:
                for row in csv.DictReader(f, delimiter="\t"):
                    speaker_id_dict.setdefault(row["speaker_name"],
                                               int(row["speaker_id"]))
        return subset_csv
    if not os.path.isdir(os.path.join(directory, subset)):
        parts = download_parts(directory, SUBSETS[subset], user, password)
        zip_path = concatenate_parts(
            parts, os.path.join(directory, subset + ".zip"))
        verify_md5(zip_path, MD5SUM[subset])
        extract_zip(zip_path, directory, subset)
    return convert_audio_and_make_label(directory, subset, directory,
                                        subset + ".csv", speaker_id_dict)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("directory")
    parser.add_argument("user")
    parser.add_argument("password")
    parser.add_argument("--subsets", nargs="+", default=list(SUBSETS))
    args = parser.parse_args(argv)
    shared_ids: Dict[str, int] = {}
    for subset in args.subsets:
        path = processor(args.directory, subset, args.user, args.password,
                         speaker_id_dict=shared_ids)
        print(f" > {subset}: {path}")


if __name__ == "__main__":
    main()

"""Cycles per phase of the MAS kernel on the card, from SM clocks.

    python3 scripts/mas_phase_clocks.py [B T_x T_y]

Builds ``tts_tpu_torch/ops/cuda/mas.cu`` with ``-DMAS_PHASE_CLOCKS`` into
``build/`` (beside, not over, the library the port loads), runs it on
chip_smoke.py's MAS inputs (32 x 192 x 864 by default), checks the path
against the plain version, and prints per item: cycles reading the
lengths, in the DP, until the staging warps are done, in the backtrack and
writing the path's ones, with the call's time by CUDA events (20 calls).
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from tts_tpu_torch.ops.cuda import build  # noqa: E402
from tts_tpu_torch.ops.mas import maximum_path_torch  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("mas_phase_clocks: no CUDA device", file=sys.stderr)
        return 1
    if argv:
        chip_smoke.MAS_SHAPE = tuple(int(a) for a in argv[:3])
    out = os.path.join(ROOT, "build", "mas_phase_clocks.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DMAS_PHASE_CLOCKS",
                    "-o", out, str(build.SOURCE_DIR / "mas.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mas_scratch_words.restype = ctypes.c_longlong
    lib.mas_scratch_words.argtypes = [I, I, I]
    lib.mas_forward.argtypes = [P, P, P, P, I, I, I, P]
    lib.mas_read_clocks.argtypes = [P]

    dev = torch.device("cuda")
    value, mask = chip_smoke.mas_inputs(dev, "random")
    B, T_x, T_y = value.shape
    path = torch.empty_like(value)
    scratch = torch.empty(max(lib.mas_scratch_words(B, T_x, T_y), 1),
                          dtype=torch.int32, device=dev)

    def call():
        err = lib.mas_forward(value.data_ptr(), mask.data_ptr(),
                              path.data_ptr(), scratch.data_ptr(), B, T_x,
                              T_y, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    ms = chip_smoke.cuda_time_ms(call, 20)
    call()
    torch.cuda.synchronize()
    assert torch.equal(path, maximum_path_torch(value, mask))
    clocks = (ctypes.c_ulonglong * (64 * 8))()
    lib.mas_read_clocks(ctypes.addressof(clocks))
    print(chip_smoke.card_identity())
    print({"shape": [B, T_x, T_y], "call_ms": ms})
    t_ys = (mask[:, 0, :] > 0).sum(dim=1).tolist()
    for b in range(0, min(B, 64), max(1, min(B, 64) // 8)):
        c = clocks[8 * b:8 * b + 8]
        print({"item": b, "t_y": t_ys[b], "lengths": c[1] - c[0],
               "dp": c[2] - c[1], "staging_done": c[3] - c[1],
               "backtrack": c[5] - c[4], "path_ones": c[6] - c[5],
               "total": c[6] - c[0]})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

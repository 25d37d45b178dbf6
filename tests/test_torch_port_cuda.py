"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor tts_tpu, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: 1e-4 of the largest reference magnitude (float32; TF32 is off for
the plain versions' cuDNN convs and matmuls).
"""

import pytest
import torch

from tts_tpu_torch.models.vocoder.multiband_melgan import \
    MultibandMelganGenerator
from tts_tpu_torch.ops.cuda import build
from tts_tpu_torch.ops.cuda import fused_melgan as M
from tts_tpu_torch.ops.cuda import fused_resstack as R


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("channels,t", [(24, 1000), (48, 300), (96, 130),
                                        (192, 504)])
def test_stack_kernel_matches_plain(cuda, channels, t):
    """Both layouts: (B, T, C) through fused_residual_stack and (B, C, T)
    through residual_stack_nct; reflect edges at both ends of every block."""
    g = torch.Generator().manual_seed(channels)
    n, C = 4, channels
    ops = (torch.randn(n, C // 4, C, 3, 4, generator=g) / (3 * C) ** 0.5,
           0.1 * torch.randn(n, C, generator=g),
           torch.randn(n, C // 4, 2 * C, 4, generator=g) / (2 * C) ** 0.5,
           0.1 * torch.randn(n, C, generator=g))
    x = torch.randn(2, t, C, generator=g)
    want = R.fused_residual_stack(x, *ops)
    ops_c = [o.to(cuda) for o in ops]
    before = build.LAUNCHES[R.KERNEL]
    _close(R.fused_residual_stack(x.to(cuda), *ops_c), want)
    _close(R.residual_stack_nct(x.transpose(1, 2).contiguous().to(cuda),
                                *ops_c).transpose(1, 2), want)
    assert build.LAUNCHES[R.KERNEL] - before == 2 * n


@pytest.mark.cuda
@pytest.mark.parametrize("factors", [(2, 8, 2, 2), (4, 4, 4, 4)])
def test_megakernel_matches_plain(cuda, factors):
    torch.manual_seed(0)
    gen = MultibandMelganGenerator(base_channels=384, upsample_factors=factors,
                                   num_res_blocks=4, use_weight_norm=False)
    sd = gen.state_dict()
    mel = torch.randn(2, 37, 80)
    want = M.megakernel_inference(gen, M.pack_generator_params(gen, sd, "cpu"),
                                  mel)
    got = M.megakernel_inference(gen, M.pack_generator_params(gen, sd, cuda),
                                 mel.to(cuda))
    _close(got, want)


@pytest.mark.cuda
def test_wrappers_reject_cpu_operands_for_cuda_input(cuda):
    """A CUDA tensor launches the kernel or raises; it never falls back."""
    C = 8
    ops = (torch.zeros(1, C // 4, C, 3, 4), torch.zeros(1, C),
           torch.zeros(1, C // 4, 2 * C, 4), torch.zeros(1, C))
    with pytest.raises(ValueError):
        R.fused_residual_stack(torch.zeros(1, 16, C, device=cuda), *ops)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor tts_tpu, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: 1e-4 of the largest reference magnitude (float32; TF32 is off for
the plain versions' cuDNN convs and matmuls); the alignment path (0/1) is
compared exactly.
"""

import pytest
import torch

from tts_tpu_torch.models.vocoder.multiband_melgan import \
    MultibandMelganGenerator
from tts_tpu_torch.ops.cuda import build
from tts_tpu_torch.ops.cuda import fused_melgan as M
from tts_tpu_torch.ops.cuda import fused_resstack as R
from tts_tpu_torch.ops.cuda import mas as MAS
from tts_tpu_torch.ops.mas import maximum_path, maximum_path_torch


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


def _mas_inputs(B, T_x, T_y, seed, ties):
    g = torch.Generator().manual_seed(seed)
    if ties:
        value = torch.randint(-2, 3, (B, T_x, T_y), generator=g).float()
    else:
        value = torch.randn(B, T_x, T_y, generator=g)
    t_xs = torch.randint(1, T_x + 1, (B,), generator=g)
    t_ys = torch.maximum(t_xs, torch.randint(1, T_y + 1, (B,), generator=g))
    t_xs[0], t_ys[0] = T_x, T_y
    mask = ((torch.arange(T_x)[None, :, None] < t_xs[:, None, None])
            & (torch.arange(T_y)[None, None, :] < t_ys[:, None, None]))
    return value, mask.float()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_x,T_y,ties", [(4, 17, 40, False),
                                            (8, 192, 864, False),
                                            (8, 192, 864, True),
                                            (2, 1100, 1300, False)])
def test_mas_kernel_equals_plain(cuda, B, T_x, T_y, ties):
    """Ragged lengths; integer values give many exact ties; T_x = 1100
    exceeds one block's 1024 threads."""
    value, mask = _mas_inputs(B, T_x, T_y, seed=T_x + T_y, ties=ties)
    want = maximum_path_torch(value, mask)
    before = build.LAUNCHES[MAS.KERNEL]
    got = maximum_path(value.to(cuda), mask.to(cuda))
    torch.cuda.synchronize()
    assert build.LAUNCHES[MAS.KERNEL] - before == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_mas_wrapper_rejects_cpu_operand(cuda):
    value, mask = _mas_inputs(2, 5, 9, seed=0, ties=False)
    with pytest.raises(ValueError):
        maximum_path(value.to(cuda), mask)

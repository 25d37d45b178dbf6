"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor tts_tpu, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: 1e-4 of the largest reference magnitude (float32; TF32 is off for
the plain versions' cuDNN convs and matmuls), the STFT magnitude and the
grouped conv's weight gradient included (sums of up to 2048 and B x L_out
products in another order), and so are the encoder BiLSTM and the Tacotron2
decode (each output over all steps), and the Glow encoder (B3, every output
of 2-6 layers); the grouped conv's input gradient
within 1e-5 absolute (about 44 products of unit-scale values); the
alignment path (0/1) exactly.
"""

import pytest
import torch

from tts_tpu_torch.models.vocoder.multiband_melgan import \
    MultibandMelganGenerator
from tts_tpu_torch.ops.cuda import build
from tts_tpu_torch.ops.cuda import fused_melgan as M
from tts_tpu_torch.ops.cuda import fused_resstack as R
from tts_tpu_torch.ops import grouped_conv as GC
from tts_tpu_torch.ops import stft as S
from tts_tpu_torch.ops.cuda import grouped_conv_grad as GCK
from tts_tpu_torch.ops.cuda import mas as MAS
from tts_tpu_torch.ops.cuda import stft_mag as SK
from tts_tpu_torch.ops.mas import maximum_path, maximum_path_torch
from tts_tpu_torch.ops import bilstm as BL
from tts_tpu_torch.ops import taco2_decode as TD
from tts_tpu_torch.ops.cuda import bilstm as BLK
from tts_tpu_torch.ops.cuda import taco2_decode as TDK


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
    takes five DP warps, and at T_y = 1300 its decisions do not fit in
    shared memory beside the tiles."""
    _mas_one_launch(cuda, *_mas_inputs(B, T_x, T_y, seed=T_x + T_y,
                                       ties=ties))


def _mas_one_launch(cuda, value, mask):
    """The kernel's path (one launch) against the plain version's."""
    want = maximum_path_torch(value, mask)
    before = build.LAUNCHES[MAS.KERNEL]
    got = maximum_path(value.to(cuda), mask.to(cuda))
    torch.cuda.synchronize()
    assert build.LAUNCHES[MAS.KERNEL] - before == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_x,T_y", [(3, 1, 50), (4, 31, 120),
                                       (4, 32, 120), (4, 33, 120),
                                       (3, 64, 202), (3, 65, 101),
                                       (5, 192, 300), (2, 300, 700)])
def test_mas_kernel_text_widths(cuda, B, T_x, T_y):
    """T_x at and around the DP warp's 32 lanes and several rows a lane
    (one DP warp up to 256, two beyond); T_y not a multiple of 4 (8- and
    4-byte staging)."""
    _mas_one_launch(cuda, *_mas_inputs(B, T_x, T_y, seed=T_x, ties=False))


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
def test_mas_kernel_square_lengths(cuda, ties):
    """t_x = t_y in every item: the only path is the diagonal."""
    value, _ = _mas_inputs(4, 70, 70, seed=3, ties=ties)
    lengths = torch.tensor([70, 33, 32, 1])
    idx = torch.arange(70)
    mask = ((idx[None, :, None] < lengths[:, None, None])
            & (idx[None, None, :] < lengths[:, None, None])).float()
    _mas_one_launch(cuda, value, mask)


@pytest.mark.cuda
def test_mas_kernel_zeroed_cell_inside_the_lengths(cuda):
    """A mask with zeros inside its (t_x, t_y) rectangle (not in its first
    row or column, which give the lengths): value is zeroed there and the
    path masked there, as in the plain version. Integer values: ties."""
    value, mask = _mas_inputs(6, 192, 864, seed=11, ties=True)
    mask[:, 5:9, 40] = 0.0
    mask[:, 100, 300:303] = 0.0
    mask[2, 1:, 1:] *= (torch.rand(191, 863, generator=torch.Generator()
                                   .manual_seed(1)) > 0.1).float()
    _mas_one_launch(cuda, value, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_x,T_y", [(1, 1100, 4000), (1, 2100, 2300)])
def test_mas_kernel_decisions_in_global_scratch(cuda, B, T_x, T_y):
    """Shapes whose decision plane does not fit in shared memory beside the
    tiles (1 x 1100 x 4000), and a T_x past the tiles (2100: the general
    kernel); both keep their decisions in the wrapper's scratch."""
    lib = build.library("mas", MAS._SIGNATURES)
    assert lib.mas_scratch_words(32, 192, 864) == 0
    assert lib.mas_scratch_words(B, T_x, T_y) > 0
    _mas_one_launch(cuda, *_mas_inputs(B, T_x, T_y, seed=T_y, ties=False))


@pytest.mark.cuda
def test_mas_kernel_unaligned_operands(cuda):
    """value a contiguous view at a 4-byte offset: 4-byte staging."""
    v, mask = _mas_inputs(3, 40, 96, seed=5, ties=False)
    buf = torch.zeros(v.numel() + 1, device=cuda)
    buf[1:] = v.reshape(-1).to(cuda)
    value = buf[1:].view(v.shape)
    assert value.data_ptr() % 16 == 4
    want = maximum_path_torch(v, mask)
    got = MAS.maximum_path_cuda(value, mask.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_mas_wrapper_rejects_cpu_operand(cuda):
    value, mask = _mas_inputs(2, 5, 9, seed=0, ties=False)
    with pytest.raises(ValueError):
        maximum_path(value.to(cuda), mask)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,win,T", [(171, 10, 60, 700),
                                             (683, 60, 300, 1500),
                                             (2048, 240, 1200, 5000),
                                             (1024, 120, 600, 4100),
                                             (512, 50, 240, 3000),
                                             (384, 30, 150, 1300),
                                             (2048, 240, 1200, 200000),
                                             (683, 60, 300, 100000)])
def test_stft_kernel_matches_plain(cuda, n_fft, hop, win, T):
    """The six loss resolutions: odd n_fft, bins and frame counts (3 x 71,
    3 x 26, ...) that are no multiple of the kernel's tiles; and two with
    more blocks than the card has SMs, where the staging pipeline runs
    under load."""
    y = torch.randn(3, T, generator=torch.Generator().manual_seed(n_fft))
    want = S.stft_magnitude(y, n_fft, hop, win)
    before = build.LAUNCHES[SK.KERNEL]
    got = S.stft_magnitude(y.to(cuda), n_fft, hop, win)
    torch.cuda.synchronize()
    assert build.LAUNCHES[SK.KERNEL] - before == 1
    _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop,win", [(1024, 120, 600),
                                           (2048, 240, 1200),
                                           (512, 50, 240)])
def test_stft_kernel_at_the_pwgan_batch(cuda, n_fft, hop, win):
    """The full-band resolutions at ParallelWaveGAN's training batch, 6 x
    25,600 samples: 1,284, 642 and 3,078 frames, a few blocks of rows with
    a ragged last one."""
    y = 0.3 * torch.randn(6, 25600, generator=torch.Generator().manual_seed(7))
    want = S.stft_magnitude(y, n_fft, hop, win)
    before = build.LAUNCHES[SK.KERNEL]
    got = S.stft_magnitude(y.to(cuda), n_fft, hop, win)
    torch.cuda.synchronize()
    assert build.LAUNCHES[SK.KERNEL] - before == 1
    _close(got, want)


@pytest.mark.cuda
def test_stft_function_backward_on_the_card(cuda):
    """The kernel's Function against autograd through the plain version."""
    y = torch.randn(2, 900, generator=torch.Generator().manual_seed(1),
                    device="cpu").to(cuda).requires_grad_()
    mag = S.stft_magnitude(y, 171, 10, 60)
    w = torch.randn(mag.shape, device=cuda)
    (mag * w).sum().backward()
    yp = y.detach().clone().requires_grad_()
    fr = S.frames(yp, 171, 10)
    plain = S.stft_magnitude_torch(fr.reshape(-1, 171),
                                   *S.dft_banks(171, 60, cuda))
    (plain.reshape(mag.shape) * w).sum().backward()
    _close(y.grad, yp.grad)


# (B, L, groups, n, k, stride)
GC_GEOMS = [(4, 1024, 16, 4, 41, 4), (2, 2052, 64, 4, 41, 4),
            (3, 256, 8, 4, 21, 4), (2, 300, 5, 2, 9, 2), (1, 70, 3, 1, 7, 1)]


def _gc_inputs(geom):
    B, L, g, n, k, s = geom
    gen = torch.Generator().manual_seed(L)
    x = torch.randn(B, g, L, generator=gen)
    w = 0.1 * torch.randn(g * n, 1, k, generator=gen)
    lout = (L + 2 * ((k - 1) // 2) - k) // s + 1
    dy = torch.randn(B, g * n, lout, generator=gen)
    return x, w, dy


@pytest.mark.cuda
@pytest.mark.parametrize("geom", GC_GEOMS)
def test_grouped_conv_kernels_match_plain(cuda, geom):
    """Both kernels against the plain tap loops; ragged chunks of output
    positions, strides 1-4, 1-4 outputs per group."""
    B, L, g, n, k, s = geom
    x, w, dy = _gc_inputs(geom)
    before = dict(build.LAUNCHES)
    dw = GC.grouped_conv_wgrad(x.to(cuda), dy.to(cuda), k, s, g)
    dx = GC.grouped_conv_dgrad(dy.to(cuda), w.to(cuda), L, s, g)
    torch.cuda.synchronize()
    assert build.LAUNCHES[GCK.WGRAD] - before.get(GCK.WGRAD, 0) == 1
    assert build.LAUNCHES[GCK.DGRAD] - before.get(GCK.DGRAD, 0) == 1
    _close(dw, GC.grouped_conv_wgrad_torch(x, dy, k, s, g))
    torch.testing.assert_close(
        dx.cpu(), GC.grouped_conv_dgrad_torch(dy, w, L, s, g), rtol=0,
        atol=1e-5)


# wgrad edges (B, L, groups, n, k, stride): odd B; B no multiple of the
# items a block takes; L_out no multiple of a segment (512 at k 41, s 4);
# n < 4; s < 4; k = 63 (several tap groups a phase); short items packed
# several to a pass; the float4 path (s 4, k 41, L_out a multiple of 4) at
# an odd B, with a ragged last segment and with 2 items a pass
WGRAD_EDGES = [(3, 4100, 8, 4, 41, 4), (5, 1000, 6, 4, 41, 4),
               (7, 97, 5, 3, 63, 1), (3, 2050, 4, 2, 63, 2),
               (2, 999, 3, 1, 63, 3), (9, 44, 7, 4, 41, 4),
               (1, 300, 2, 4, 11, 1), (65, 1024, 3, 4, 41, 4),
               (3, 8192, 5, 4, 41, 4), (3, 2064, 4, 4, 41, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", WGRAD_EDGES)
def test_wgrad_kernel_edge_geometries(cuda, geom):
    B, L, g, n, k, s = geom
    x, _, dy = _gc_inputs(geom)
    dw = GCK.grouped_conv_wgrad_cuda(x.to(cuda), dy.to(cuda), k, s, g)
    torch.cuda.synchronize()
    _close(dw, GC.grouped_conv_wgrad_torch(x, dy, k, s, g))


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(64, 4096, 64, 4, 41, 4),
                                  (7, 97, 5, 3, 63, 1)])
def test_wgrad_is_bitwise_deterministic(cuda, geom):
    """No atomics: two calls on the same inputs give the same bits (down_1's
    shape at batch 64, and an edge geometry)."""
    B, L, g, n, k, s = geom
    gen = torch.Generator(cuda).manual_seed(L)
    x = torch.randn(B, g, L, device=cuda, generator=gen)
    lout = (L + 2 * ((k - 1) // 2) - k) // s + 1
    dy = torch.randn(B, g * n, lout, device=cuda, generator=gen)
    first = GCK.grouped_conv_wgrad_cuda(x, dy, k, s, g)
    second = GCK.grouped_conv_wgrad_cuda(x, dy, k, s, g)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# dgrad edges (B, L, groups, n, k, stride): odd B on the float4 path; its
# last segment (256 float4s) ragged (L 4112) and a row shorter than the
# dy window (L 48); n < 4; k 9, 57 and 1 (pad 4, 28, 0) on the float4 path;
# L_out no multiple of 4 (L 4100), s < 4 and k = 63 (pad 31) on the general
# kernel
DGRAD_EDGES = [(5, 1024, 6, 4, 41, 4), (3, 4112, 8, 4, 41, 4),
               (7, 48, 5, 4, 41, 4), (3, 2048, 4, 2, 41, 4),
               (2, 1024, 3, 3, 41, 4), (2, 512, 4, 4, 9, 4),
               (2, 512, 3, 4, 57, 4), (2, 64, 3, 4, 1, 4),
               (3, 4100, 8, 4, 41, 4), (7, 97, 5, 3, 63, 1),
               (3, 2050, 4, 2, 63, 2), (2, 999, 3, 1, 63, 3),
               (3, 1024, 4, 4, 63, 4)]


def _dx_close(got, dy, w, L, s, g):
    torch.testing.assert_close(
        got.cpu(), GC.grouped_conv_dgrad_torch(dy, w, L, s, g), rtol=0,
        atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", DGRAD_EDGES)
def test_dgrad_kernel_edge_geometries(cuda, geom):
    B, L, g, n, k, s = geom
    _, w, dy = _gc_inputs(geom)
    before = build.LAUNCHES[GCK.DGRAD]
    dx = GCK.grouped_conv_dgrad_cuda(dy.to(cuda), w.to(cuda), L, s, g)
    torch.cuda.synchronize()
    assert build.LAUNCHES[GCK.DGRAD] - before == 1
    _dx_close(dx, dy, w, L, s, g)


@pytest.mark.cuda
def test_dgrad_kernel_dy_at_a_4_byte_offset(cuda):
    """dy a contiguous view 4 bytes into a larger buffer: not 16-byte
    aligned, so the general kernel, still one launch and still right."""
    B, L, g, n, k, s = geom = (3, 1024, 16, 4, 41, 4)
    _, w, dy = _gc_inputs(geom)
    buf = torch.zeros(dy.numel() + 1, device=cuda)
    buf[1:] = dy.reshape(-1).to(cuda)
    dy_view = buf[1:].view(dy.shape)
    assert dy_view.data_ptr() % 16 == 4
    before = build.LAUNCHES[GCK.DGRAD]
    dx = GCK.grouped_conv_dgrad_cuda(dy_view, w.to(cuda), L, s, g)
    torch.cuda.synchronize()
    assert build.LAUNCHES[GCK.DGRAD] - before == 1
    _dx_close(dx, dy, w, L, s, g)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(64, 4096, 64, 4, 41, 4),
                                  (7, 97, 5, 3, 63, 1)])
def test_dgrad_is_bitwise_deterministic(cuda, geom):
    """Each dx sample summed by one thread in a fixed order: two calls give
    the same bits (down_1's shape at batch 64, and the general kernel)."""
    B, L, g, n, k, s = geom
    gen = torch.Generator(cuda).manual_seed(L)
    w = 0.1 * torch.randn(g * n, 1, k, device=cuda, generator=gen)
    lout = (L + 2 * ((k - 1) // 2) - k) // s + 1
    dy = torch.randn(B, g * n, lout, device=cuda, generator=gen)
    first = GCK.grouped_conv_dgrad_cuda(dy, w, L, s, g)
    second = GCK.grouped_conv_dgrad_cuda(dy, w, L, s, g)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_discriminator_backward_runs_the_kernels(cuda):
    """A full-width discriminator's backward on the card launches both
    kernels for down_0..2 of every scale and matches the CPU's plain
    gradients."""
    from tts_tpu_torch.models.vocoder.melgan import \
        MelganMultiscaleDiscriminator
    torch.manual_seed(0)
    disc = MelganMultiscaleDiscriminator()
    y = torch.randn(2, 1, 4096, generator=torch.Generator().manual_seed(2))
    scores, _ = disc(y)
    sum(s.square().mean() for s in scores).backward()
    want = {n: p.grad.clone() for n, p in disc.named_parameters()}
    disc.zero_grad()
    disc.to(cuda)
    before = dict(build.LAUNCHES)
    scores, _ = disc(y.to(cuda))
    sum(s.square().mean() for s in scores).backward()
    torch.cuda.synchronize()
    assert build.LAUNCHES[GCK.WGRAD] - before.get(GCK.WGRAD, 0) == 9
    # down_0's input gradient too: conv_in's weights need it
    assert build.LAUNCHES[GCK.DGRAD] - before.get(GCK.DGRAD, 0) == 9
    for name, p in disc.named_parameters():
        _close(p.grad, want[name])


@pytest.mark.cuda
def test_new_wrappers_never_fall_back(cuda, monkeypatch):
    """CUDA tensors launch the kernels or raise: the plain versions are
    never reached, and a CPU operand beside a CUDA one raises."""
    def boom(*args):
        raise AssertionError("plain version reached with CUDA tensors")
    monkeypatch.setattr(S, "stft_magnitude_torch", boom)
    monkeypatch.setattr(GC, "grouped_conv_wgrad_torch", boom)
    monkeypatch.setattr(GC, "grouped_conv_dgrad_torch", boom)
    S.stft_magnitude(torch.randn(2, 600, device=cuda), 171, 10, 60)
    x, w, dy = (t.to(cuda) for t in _gc_inputs(GC_GEOMS[0]))
    GC.grouped_conv_wgrad(x, dy, 41, 4, 16)
    GC.grouped_conv_dgrad(dy, w, 1024, 4, 16)
    with pytest.raises(ValueError):
        SK.stft_mag_cuda(torch.randn(4, 171, device=cuda),
                         *S.half_banks(171, 60, torch.device("cpu")))
    with pytest.raises(ValueError):
        GCK.grouped_conv_wgrad_cuda(x, dy.cpu(), 41, 4, 16)
    with pytest.raises(ValueError):     # 4 inputs per group: not taken
        GCK.grouped_conv_dgrad_cuda(dy, w.repeat(1, 4, 1).contiguous(), 1024,
                                    4, 16)


# ---------------------------------------------------------------------------
# Tacotron2: encoder BiLSTM (B7) and the whole decode (B8)
# ---------------------------------------------------------------------------

def _bilstm_inputs(B, T, C, H, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, C, generator=g)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0] = T
    ws = [torch.randn(C + H, 4 * H, generator=g) / (C + H) ** 0.5
          for _ in range(2)]
    bs = [0.1 * torch.randn(4 * H, generator=g) for _ in range(2)]
    return x, lengths, (ws[0], bs[0], ws[1], bs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,H", [(3, 11, 32, 16), (9, 37, 512, 256),
                                     (64, 128, 512, 256)])
def test_bilstm_kernel_matches_plain(cuda, B, T, C, H):
    """Ragged lengths; batches that are no multiple of the 8 items a block
    takes; bench.py's geometry (64 x 128 x 512)."""
    x, lengths, weights = _bilstm_inputs(B, T, C, H, seed=T)
    want = BL.bilstm(x, lengths, *weights)
    before = build.LAUNCHES[BLK.KERNEL]
    got = BL.bilstm(x.to(cuda), lengths.to(cuda),
                    *(w.to(cuda) for w in weights))
    torch.cuda.synchronize()
    assert build.LAUNCHES[BLK.KERNEL] - before == 1 + T
    _close(got, want)


def _small_decoder(encoder_dim, attn_dim, r, r_init, seed):
    from tts_tpu_torch.models.tacotron2 import Tacotron2
    torch.manual_seed(seed)
    model = Tacotron2(num_chars=20, r=r, r_init=r_init,
                      encoder_dim=encoder_dim, embedding_dim=encoder_dim,
                      attn_dim=attn_dim)
    return TD.pack_decoder_params(model.decoder)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,A,r,r_init", [(3, 37, 64, 32, 2, 3),
                                              (2, 130, 512, 128, 7, 7)])
def test_decode_kernel_matches_plain(cuda, B, T, D, A, r, r_init):
    """12 steps from random encoder outputs with a ragged mask; T = 130 is
    no multiple of the attention kernel's 32-position tiles."""
    packed = _small_decoder(D, A, r, r_init, seed=T)
    g = torch.Generator().manual_seed(T)
    enc = torch.randn(B, T, D, generator=g)
    pi = torch.randn(B, T, A, generator=g)
    lengths = torch.tensor([T] + [T // 2] * (B - 1))
    mask = torch.arange(T)[None] < lengths[:, None]
    want = TD.fused_decode(enc, pi, mask, packed, 12, r)
    before = build.LAUNCHES[TDK.KERNEL]
    got = TD.fused_decode(enc.to(cuda), pi.to(cuda), mask.to(cuda),
                          {k: v.to(cuda) for k, v in packed.items()}, 12, r)
    torch.cuda.synchronize()
    assert build.LAUNCHES[TDK.KERNEL] - before == 12 * TDK.LAUNCHES_PER_STEP
    for g_, w_ in zip(got, want):
        assert torch.isfinite(g_).all()
        _close(g_, w_)


@pytest.mark.cuda
def test_fused_inference_on_the_card(cuda):
    """The whole fast path (embedding, convs, B7, B8, postnet) on the card
    against the same model on the CPU."""
    from tts_tpu_torch.infer.fast_decode import taco2_fused_inference
    from tts_tpu_torch.models.tacotron2 import Tacotron2
    torch.manual_seed(0)
    model = Tacotron2(num_chars=20, r=2, encoder_dim=64, embedding_dim=64,
                      attn_dim=32, max_decoder_steps=10).eval()
    text = torch.randint(1, 20, (2, 19), generator=torch.Generator()
                         .manual_seed(1))
    lengths = torch.tensor([19, 12])
    want = taco2_fused_inference(model, text, lengths)
    model.to(cuda)
    before = dict(build.LAUNCHES)
    got = taco2_fused_inference(model, text.to(cuda), lengths.to(cuda))
    torch.cuda.synchronize()
    assert build.LAUNCHES[BLK.KERNEL] - before.get(BLK.KERNEL, 0) == 1 + 19
    assert build.LAUNCHES[TDK.KERNEL] - before.get(TDK.KERNEL, 0) == \
        10 * TDK.LAUNCHES_PER_STEP
    assert torch.equal(got["mel_lengths"].cpu(), want["mel_lengths"])
    for key in ("decoder_outputs", "postnet_outputs", "alignments",
                "stop_logits"):
        _close(got[key], want[key])


@pytest.mark.cuda
def test_taco2_wrappers_refuse_bf16_and_never_fall_back(cuda, monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("plain version reached with CUDA tensors")
    monkeypatch.setattr(BL, "bilstm_torch", boom)
    monkeypatch.setattr(TD, "decode_torch", boom)
    x, lengths, weights = _bilstm_inputs(2, 5, 32, 16, seed=0)
    x, lengths = x.to(cuda), lengths.to(cuda)
    weights = [w.to(cuda) for w in weights]
    BL.bilstm(x, lengths, *weights)
    with pytest.raises(ValueError, match="float32"):
        BL.bilstm(x, lengths, *weights, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        BL.bilstm(x.bfloat16(), lengths, *weights)
    packed = {k: v.to(cuda) for k, v in
              _small_decoder(64, 32, 2, 2, seed=0).items()}
    enc, pi = torch.randn(2, 9, 64, device=cuda), torch.randn(2, 9, 32,
                                                              device=cuda)
    mask = torch.ones(2, 9, device=cuda)
    TD.fused_decode(enc, pi, mask, packed, 2, 2)
    with pytest.raises(ValueError, match="float32"):
        TD.fused_decode(enc, pi, mask, packed, 2, 2,
                        compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        TD.fused_decode(enc, pi.cpu(), mask, packed, 2, 2)


# ---------------------------------------------------------------------------
# Glow-TTS: the whole eval-mode encoder (B3)
# ---------------------------------------------------------------------------

def _seeded_encoder(hidden, heads, filt, filt_dp, layers, seed):
    """A port GlowTTSEncoder with every parameter drawn from the seed:
    fan-in scaled weights, LayerNorm scales near 1, small biases. Nothing is
    zero, so the prenet's zero-initialised projection cannot hide a wrong
    prenet."""
    from tts_tpu_torch.models.glow.encoder import GlowTTSEncoder
    enc = GlowTTSEncoder(num_chars=60, hidden_channels=hidden,
                         filter_channels=filt, filter_channels_dp=filt_dp,
                         num_heads=heads, num_layers=layers).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if name.endswith("gamma"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
            elif p.dim() == 1:
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
            else:
                fan_in = p[0].numel() if "emb_rel" not in name \
                    else p.shape[-1]
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
    return enc


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,heads,filt,filt_dp,layers,B,T", [
    (32, 2, 64, 48, 2, 4, 32),        # the CPU tests' width, k_ch 16
    (16, 2, 64, 48, 2, 3, 37),        # k_ch 8, T no multiple of a tile
    (192, 2, 768, 256, 6, 2, 96),     # the shipped width, k_ch 96
    (192, 2, 768, 256, 2, 3, 512),    # the largest text bucket
    (192, 2, 768, 256, 2, 16, 32),
    (192, 2, 768, 256, 1, 64, 160)])    # 64-row tiles fill the card
def test_glow_encoder_kernel_matches_plain(cuda, hidden, heads, filt,
                                           filt_dp, layers, B, T):
    """Ragged lengths (one item full, one of length 1); padded rows of the
    output exactly 0; the launches of one call as derived."""
    from tts_tpu_torch.ops import glow_encoder as GE
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    enc = _seeded_encoder(hidden, heads, filt, filt_dp, layers, seed=T)
    packed = GE.pack_glow_encoder_params(enc)
    g = torch.Generator().manual_seed(T + 1)
    emb = torch.randn(B, T, hidden, generator=g)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0], lengths[-1] = T, 1
    mask = (torch.arange(T)[None] < lengths[:, None]).float()
    packed_c = GE.PackedGlowEncoder(packed.flat.to(cuda), packed.dims)
    want = GE.glow_encoder_torch(packed_c, emb.to(cuda), mask.to(cuda))
    before = build.LAUNCHES[GEK.KERNEL]
    got = GEK.glow_encoder_cuda(packed_c.flat, packed.dims, emb.to(cuda),
                                mask.to(cuda))
    torch.cuda.synchronize()
    assert build.LAUNCHES[GEK.KERNEL] - before == \
        GEK.launches_per_call(packed.dims) == 3 + 1 + 5 * layers + 4
    assert torch.isfinite(got).all()
    _close(got, want)
    _close(got, GE.glow_encoder_torch(packed, emb, mask))   # the CPU's
    assert not got[mask.to(cuda) == 0].any(), "padded rows must be 0"


@pytest.mark.cuda
def test_glow_inference_reaches_the_kernel(cuda, monkeypatch):
    """GlowTTS.inference in eval on the card runs B3, never the plain
    version, and matches the same model on the CPU; tensors that need a
    gradient are refused."""
    from tts_tpu_torch.models.glow_tts import GlowTTS
    from tts_tpu_torch.ops import glow_encoder as GE
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    torch.manual_seed(0)
    model = GlowTTS(num_chars=60, hidden_channels_enc=32,
                    hidden_channels_dec=32, filter_channels=64,
                    filter_channels_dp=48, num_layers_enc=2,
                    num_flow_blocks_dec=2, num_block_layers=2).eval()
    model.encoder.load_state_dict(
        _seeded_encoder(32, 2, 64, 48, 2, seed=3).state_dict())
    with torch.no_grad():     # pin the durations (ceil flips on an ulp)
        model.encoder.duration_predictor.proj.weight.zero_()
        model.encoder.duration_predictor.proj.bias.fill_(1.5)
    text = torch.randint(1, 60, (2, 21), generator=torch.Generator()
                         .manual_seed(4))
    lengths = torch.tensor([21, 13])
    want = model.inference(text, lengths, noise_scale=0.0, y_max_length=96)
    model.to(cuda)
    model.store_inverse()

    def boom(*args, **kwargs):
        raise AssertionError("plain version reached with CUDA tensors")
    monkeypatch.setattr(GE, "glow_encoder_torch", boom)
    before = build.LAUNCHES[GEK.KERNEL]
    got = model.inference(text.to(cuda), lengths.to(cuda), noise_scale=0.0,
                          y_max_length=96)
    torch.cuda.synchronize()
    assert build.LAUNCHES[GEK.KERNEL] - before == 3 + 1 + 5 * 2 + 4
    assert torch.equal(got["mel_lengths"].cpu(), want["mel_lengths"])
    for key in ("model_outputs", "durations_log"):
        _close(got[key], want[key])
    emb = torch.randn(1, 8, 32, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no_grad"):
        GEK.glow_encoder_cuda(model.encoder.packed_weights().flat,
                              model.encoder.packed_weights().dims, emb,
                              torch.ones(1, 8, device=cuda))


@pytest.mark.cuda
def test_glow_encode_above_the_kernels_text_limit(cuda):
    """GlowTTS.encode on the card: at the longest text B3's attention block
    holds (exported by glow_encoder.cu) B3 runs; one symbol more runs the
    module, which matches it; B3 itself refuses that length."""
    from tts_tpu_torch.models.glow_tts import GlowTTS
    from tts_tpu_torch.ops import glow_encoder as GE
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    torch.manual_seed(0)
    model = GlowTTS(num_chars=60, hidden_channels_enc=192,
                    hidden_channels_dec=32, filter_channels=768,
                    filter_channels_dp=256, num_layers_enc=1,
                    num_flow_blocks_dec=2, num_block_layers=2)
    model.encoder.load_state_dict(
        _seeded_encoder(192, 2, 768, 256, 1, seed=7).state_dict())
    model = model.to(cuda).eval()
    limit = GE.fused_encoder_max_length(model.encoder, cuda)
    assert limit == GEK.max_text_length(96, cuda) > 512
    g = torch.Generator().manual_seed(8)
    outs = {}
    for T in (limit, limit + 1):
        text = torch.randint(1, 60, (1, T), generator=g).to(cuda)
        lengths = torch.tensor([T], device=cuda)
        before = build.LAUNCHES[GEK.KERNEL]
        with torch.no_grad():
            got = model.encode(text, lengths)
            torch.cuda.synchronize()
            ran = build.LAUNCHES[GEK.KERNEL] - before
            want = model.encoder(text, lengths)
        assert ran == (GEK.launches_per_call(
            model.encoder.packed_weights().dims) if T == limit else 0)
        for a, b in zip(got[:3], want[:3]):
            _close(a, b)
        outs[T] = (text, lengths)
    text, lengths = outs[limit + 1]
    packed = model.encoder.packed_weights()
    with torch.no_grad(), pytest.raises(RuntimeError, match="failed"):
        GE.fused_glow_encoder(model.encoder, packed, text, lengths)


def _to_both(module_fn, seed, cuda):
    torch.manual_seed(seed)
    cpu = module_fn().eval()
    dev = module_fn().eval()
    dev.load_state_dict(cpu.state_dict())
    return cpu, dev.to(cuda)


@pytest.mark.cuda
def test_pwgan_and_its_discriminators_on_the_card(cuda):
    """ParallelWaveGAN's generator (shipped widths, 6 blocks in 2 stacks),
    its two discriminators and the random window discriminators on the
    card against the same modules on the CPU (same noise, same offsets);
    ``inference`` with a CPU generator gives the CPU's audio."""
    from tts_tpu_torch.models.vocoder.pwgan import (
        ParallelWaveganDiscriminator, ParallelWaveganGenerator,
        ResidualParallelWaveganDiscriminator)
    from tts_tpu_torch.models.vocoder.rwd import RandomWindowDiscriminator
    gen_cpu, gen = _to_both(lambda: ParallelWaveganGenerator(
        num_res_blocks=6, stacks=2), 0, cuda)
    g = torch.Generator().manual_seed(1)
    mel = torch.randn(2, 80, 24, generator=g)
    z = torch.randn(2, 1, 24 * 256, generator=g)
    with torch.no_grad():
        _close(gen(z.to(cuda), mel.to(cuda)), gen_cpu(z, mel))
        _close(gen.inference(mel.to(cuda), torch.Generator().manual_seed(0)),
               gen_cpu.inference(mel, torch.Generator().manual_seed(0)))
    y = torch.randn(2, 1, 24 * 256, generator=g) * 0.3
    for make in (ParallelWaveganDiscriminator,
                 lambda: ResidualParallelWaveganDiscriminator(num_layers=6,
                                                              stacks=2)):
        d_cpu, d = _to_both(make, 2, cuda)
        with torch.no_grad():
            _close(d(y.to(cuda)), d_cpu(y))
    d_cpu, d = _to_both(RandomWindowDiscriminator, 3, cuda)
    offsets = d.draw_offsets(y.shape[-1], mel.shape[-1],
                             torch.Generator().manual_seed(4))
    with torch.no_grad():
        got, _ = d(y.to(cuda), mel.to(cuda), offsets=offsets)
        want, _ = d_cpu(y, mel, offsets=offsets)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.cuda
def test_istft_melgan_on_the_card(cuda):
    """The iSTFT generator (shipped widths) on the card against the CPU in
    float32; in bfloat16 (cast parameters, as the mixed-precision step)
    its head runs in float32 and its output is float32 and finite."""
    from torch.func import functional_call

    from tts_tpu_torch.models.vocoder.istft_melgan import \
        ISTFTMelganGenerator
    cpu, gen = _to_both(ISTFTMelganGenerator, 5, cuda)
    mel = torch.randn(2, 80, 20, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        _close(gen(mel.to(cuda)), cpu(mel))
        _close(gen.inference(mel.to(cuda)), cpu.inference(mel))
        bf16 = {n: p.to(torch.bfloat16) for n, p in gen.named_parameters()}
        out = functional_call(gen, bf16, (mel.to(cuda, torch.bfloat16),))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_pwgan_rwd_gan_step_on_the_card(cuda):
    """One GAN step of a narrow ParallelWaveGAN against the random window
    discriminators on the card, noise from a card generator and crops from
    a host one: B5 launches 6 times (3 resolutions x y_hat and y), losses
    are finite and both networks move."""
    from tts_tpu_torch.models.vocoder.pwgan import ParallelWaveganGenerator
    from tts_tpu_torch.models.vocoder.rwd import RandomWindowDiscriminator
    from tts_tpu_torch.train.gan import GANTrainStep
    from tts_tpu_torch.train.optim import make_optimizer
    torch.manual_seed(0)
    gen = ParallelWaveganGenerator(num_res_blocks=3, stacks=3).to(cuda)
    disc = RandomWindowDiscriminator().to(cuda)
    step = GANTrainStep(gen, disc, make_optimizer(gen), make_optimizer(disc),
                        conv_pad=0,
                        generator=torch.Generator(cuda).manual_seed(1),
                        crop_generator=torch.Generator().manual_seed(1),
                        gen_loss_kwargs={"use_stft_loss": True})
    g = torch.Generator().manual_seed(2)
    batch = {s: {"mel": torch.randn(2, 80, 32, generator=g).to(cuda),
                 "audio": (0.3 * torch.randn(2, 1, 8192, generator=g)
                           ).to(cuda)} for s in "GD"}
    g0 = [p.detach().clone() for p in gen.parameters()]
    d0 = [p.detach().clone() for p in disc.parameters()]
    before = build.LAUNCHES.get(SK.KERNEL, 0)
    losses = step(batch["G"], batch["D"], train_disc=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES[SK.KERNEL] - before == 6
    assert all(torch.isfinite(torch.tensor(v)) for v in losses.values())
    assert any(not torch.equal(p, q) for p, q in zip(gen.parameters(), g0))
    assert any(not torch.equal(p, q) for p, q in zip(disc.parameters(), d0))


@pytest.mark.cuda
def test_speaker_encoder_on_the_card(cuda):
    """The shipped encoder (3 x LSTM 768 -> 256, cuDNN) on 20 mels of 161
    frames: d-vectors, the sliding-window embedding of a longer mel and one
    GE2E training step's loss and updates against the CPU; no hand-written
    kernel launches."""
    import copy

    from torch import nn

    from tts_tpu_torch.losses.ge2e import GE2ELoss
    from tts_tpu_torch.models.speaker_encoder import SpeakerEncoder
    from tts_tpu_torch.train.optim import make_optimizer
    from tts_tpu_torch.train.trainer_encoder import train_step
    torch.manual_seed(0)
    cpu = nn.ModuleDict({"model": SpeakerEncoder(), "criterion": GE2ELoss()})
    dev = copy.deepcopy(cpu).to(cuda)
    g = torch.Generator().manual_seed(1)
    mels = torch.randn(20, 161, 40, generator=g)
    long = torch.randn(2, 400, 40, generator=g)
    before = sum(build.LAUNCHES.values())
    with torch.no_grad():
        _close(dev["model"](mels.to(cuda)), cpu["model"](mels))
        _close(dev["model"].compute_embedding(long.to(cuda)),
               cpu["model"].compute_embedding(long))
    losses = [train_step(m, make_optimizer(m, lr=1e-4, grad_clip=3.0),
                         x, 4, 5)
              for m, x in ((cpu, mels), (dev, mels.to(cuda)))]
    torch.testing.assert_close(losses[1].cpu(), losses[0], rtol=1e-5,
                               atol=0)
    for (name, p), q in zip(cpu.named_parameters(), dev.parameters()):
        torch.testing.assert_close(q.detach().cpu(), p.detach(), rtol=0,
                                   atol=1e-6, msg=name)
    assert sum(build.LAUNCHES.values()) == before


@pytest.mark.cuda
def test_multispeaker_models_refuse_b3_and_b8_on_the_card(cuda):
    """A multi-speaker Glow-TTS infers on the card without B3 (its encoder
    module), and Tacotron2 with d-vectors and GST without B8 (the plain
    decode) but with B7 (1 + T launches); each matches the CPU."""
    from tts_tpu_torch.infer.synthesis import run_model
    from tts_tpu_torch.models.glow_tts import GlowTTS
    from tts_tpu_torch.models.tacotron2 import Tacotron2
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    torch.manual_seed(0)
    glow = GlowTTS(num_chars=60, num_speakers=4, hidden_channels_enc=32,
                   hidden_channels_dec=32, filter_channels=64,
                   filter_channels_dp=48, num_layers_enc=2,
                   num_flow_blocks_dec=2, num_block_layers=2).eval()
    with torch.no_grad():     # pin the durations (ceil flips on an ulp)
        glow.encoder.duration_predictor.proj.weight.zero_()
        glow.encoder.duration_predictor.proj.bias.fill_(1.5)
    text = torch.randint(1, 60, (2, 21), generator=torch.Generator()
                         .manual_seed(4))
    lengths, ids = torch.tensor([21, 13]), torch.tensor([3, 1])
    want = glow.inference(text, lengths, speaker_ids=ids, noise_scale=0.0,
                          y_max_length=96)
    glow.to(cuda).store_inverse()
    before = build.LAUNCHES[GEK.KERNEL]
    got = glow.inference(text.to(cuda), lengths.to(cuda),
                         speaker_ids=ids.to(cuda), noise_scale=0.0,
                         y_max_length=96)
    torch.cuda.synchronize()
    assert build.LAUNCHES[GEK.KERNEL] == before
    assert torch.equal(got["mel_lengths"].cpu(), want["mel_lengths"])
    _close(got["model_outputs"], want["model_outputs"])

    c = {"model": "tacotron2"}
    seq = torch.randint(1, 60, (1, 32), generator=torch.Generator()
                        .manual_seed(5))
    for kw, cond in (
            (dict(num_speakers=3, external_speaker_dim=16),
             {"speaker_embedding": torch.randn(16).numpy()}),
            (dict(use_gst=True, gst_embedding_dim=64, gst_num_heads=2),
             {"style_mel": torch.randn(1, 45, 80).numpy()})):
        torch.manual_seed(1)
        taco = Tacotron2(num_chars=60, r=2, encoder_dim=64, embedding_dim=64,
                         attn_dim=32, max_decoder_steps=12, **kw).eval()
        want = run_model(taco, seq, c, **cond)
        taco.to(cuda)
        before = dict(build.LAUNCHES)
        got = run_model(taco, seq.to(cuda), c, **cond)
        torch.cuda.synchronize()
        assert build.LAUNCHES[TDK.KERNEL] == before.get(TDK.KERNEL, 0)
        assert (build.LAUNCHES[BLK.KERNEL] - before.get(BLK.KERNEL, 0)
                == 1 + seq.shape[1])
        for key in ("decoder_outputs", "stop_logits", "alignments"):
            _close(got[key], want[key])


@pytest.mark.cuda
def test_gst_on_the_card(cuda):
    """GST at full width (512, 4 heads, 10 tokens) on odd and even mel
    lengths, eval and train mode (running statistics), against the CPU."""
    import copy

    from tts_tpu_torch.models.gst import GST
    torch.manual_seed(0)
    cpu = GST()
    dev = copy.deepcopy(cpu).to(cuda)
    g = torch.Generator().manual_seed(2)
    for T in (117, 120):
        x = torch.randn(4, T, 80, generator=g)
        with torch.no_grad():
            _close(dev.eval()(x.to(cuda)), cpu.eval()(x))
        _close(dev.train()(x.to(cuda)).detach(), cpu.train()(x).detach())
        for a, b in zip(dev.encoder.bns, cpu.encoder.bns):
            _close(a.running_var, b.running_var)
            _close(a.running_mean, b.running_mean)


@pytest.mark.cuda
def test_server_refuses_bad_speaker_id_and_serves_on(cuda, tmp_path):
    """A 2-speaker Glow-TTS served on the card: speaker ids 2, -1 and "x"
    get 400 and reach nothing on the card; the next request (speaker 1)
    still returns audio, and the process's CUDA context still works."""
    import json
    import os
    import threading
    import urllib.error
    import urllib.parse
    import urllib.request

    from tts_tpu_torch.audio.processor import read_wav
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.server.server import create_server
    from tts_tpu_torch.text import num_symbols

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    c = load_config(os.path.join(root, "configs", "glow_tts_ljspeech.json"))
    c.update(hidden_channels_encoder=32, hidden_channels_decoder=32,
             use_phonemes=False, num_speakers=2)
    c["audio"]["griffin_lim_iters"] = 4
    torch.manual_seed(0)
    model = setup_model(num_symbols(False), 2, c)
    (tmp_path / "glow.json").write_text(json.dumps(dict(c)))
    torch.save({"model": model.state_dict()}, tmp_path / "glow.pt")
    synth = Synthesizer(str(tmp_path / "glow.pt"),
                        str(tmp_path / "glow.json"), device=cuda)
    server = create_server(synth, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{server.server_address[1]}/api/tts?"
           + "text=Hello%20world.&speaker_id=")
    try:
        for bad in ("2", "-1", "x"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(url + urllib.parse.quote(bad),
                                       timeout=120)
            assert e.value.code == 400, bad
        with urllib.request.urlopen(url + "1", timeout=300) as r:
            wav, _ = read_wav(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert len(wav) > 0 and abs(wav).max() > 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("memory_size", [-1, 5])
def test_tacotron_v1_on_the_card(cuda, memory_size):
    """Tacotron v1 (its fixed widths, r 3 of r_init 7, 513 linear bins):
    the decode of 20 steps on the card against the CPU, never through B7
    or B8; a train-mode forward moves the CBHGs' running statistics alike
    on both."""
    import copy

    from tts_tpu_torch.models.tacotron import Tacotron
    torch.manual_seed(0)
    cpu = Tacotron(num_chars=60, r=3, r_init=7, linear_dim=513,
                   memory_size=memory_size, max_decoder_steps=20,
                   stop_threshold=2.0).eval()
    dev = copy.deepcopy(cpu).to(cuda)
    text = torch.randint(1, 60, (2, 32), generator=torch.Generator()
                         .manual_seed(3))
    lengths = torch.tensor([32, 19])
    want = cpu.inference(text, lengths)
    before = dict(build.LAUNCHES)
    got = dev.inference(text.to(cuda), lengths.to(cuda))
    torch.cuda.synchronize()
    assert build.LAUNCHES[BLK.KERNEL] == before.get(BLK.KERNEL, 0)
    assert build.LAUNCHES[TDK.KERNEL] == before.get(TDK.KERNEL, 0)
    for key in ("decoder_outputs", "postnet_outputs", "alignments",
                "stop_logits"):
        _close(got[key], want[key])
    mel = torch.randn(2, 24, 80, generator=torch.Generator().manual_seed(4))
    for m in (cpu, dev):
        m.train()
        for drop in m.modules():
            if hasattr(drop, "rate"):
                drop.rate = 0.0
    want = cpu(text, lengths, mel)
    got = dev(text.to(cuda), lengths.to(cuda), mel.to(cuda))
    _close(got["postnet_outputs"].detach(), want["postnet_outputs"].detach())
    stats = dict(cpu.named_buffers())
    for name, a in dev.named_buffers():
        if ".running_" in name:
            _close(a, stats[name])


@pytest.mark.cuda
def test_graves_tacotron2_refuses_b8_on_the_card(cuda):
    """A Tacotron2 with Graves attention through ``run_model``: B8 never
    launches, B7 1 + T times; the decode matches the CPU's."""
    from tts_tpu_torch.infer.fast_decode import supports_fused_decode
    from tts_tpu_torch.infer.synthesis import run_model
    from tts_tpu_torch.models.tacotron2 import Tacotron2
    torch.manual_seed(1)
    taco = Tacotron2(num_chars=60, r=2, encoder_dim=64, embedding_dim=64,
                     attn_dim=32, attn_type="graves", attn_K=5,
                     max_decoder_steps=20, stop_threshold=2.0).eval()
    assert not supports_fused_decode(taco)
    seq = torch.randint(1, 60, (1, 32), generator=torch.Generator()
                        .manual_seed(5))
    c = {"model": "tacotron2"}
    want = run_model(taco, seq, c)
    taco.to(cuda)
    before = dict(build.LAUNCHES)
    got = run_model(taco, seq.to(cuda), c)
    torch.cuda.synchronize()
    assert build.LAUNCHES[TDK.KERNEL] == before.get(TDK.KERNEL, 0)
    assert (build.LAUNCHES[BLK.KERNEL] - before.get(BLK.KERNEL, 0)
            == 1 + seq.shape[1])
    for key in ("decoder_outputs", "stop_logits", "alignments"):
        _close(got[key], want[key])


@pytest.mark.cuda
def test_streaming_runs_b7_per_chunk_on_the_card(cuda):
    """``stream_mel_chunks`` on the card: one B7 call (1 + bucket
    launches) per chunk, no B8; every chunk's mel equals the CPU's within
    1e-4 of its largest magnitude."""
    from tts_tpu_torch.infer.streaming import chunk_words, stream_mel_chunks
    from tts_tpu_torch.infer.synthesis import (bucket_text_length,
                                               text_to_seqvec)
    from tts_tpu_torch.models.tacotron2 import Tacotron2
    from tts_tpu_torch.text import num_symbols
    torch.manual_seed(2)
    taco = Tacotron2(num_chars=num_symbols(False), r=2, encoder_dim=64,
                     embedding_dim=64, attn_dim=32, max_decoder_steps=16,
                     stop_threshold=2.0).eval()
    c = {"model": "tacotron2", "use_phonemes": False,
         "text_cleaner": "english_cleaners"}
    text = ("the quick brown fox jumps over the lazy dog while seven "
            "small birds sing")
    want = list(stream_mel_chunks(taco, text, c, torch.device("cpu"),
                                  chunk_chars=20, decoder_steps=16))
    taco.to(cuda)
    before = dict(build.LAUNCHES)
    got = list(stream_mel_chunks(taco, text, c, cuda, chunk_chars=20,
                                 decoder_steps=16))
    torch.cuda.synchronize()
    chunks = chunk_words(text, 20)
    assert len(got) == len(want) == len(chunks)
    assert build.LAUNCHES[TDK.KERNEL] == before.get(TDK.KERNEL, 0)
    assert (build.LAUNCHES[BLK.KERNEL] - before.get(BLK.KERNEL, 0)
            == sum(1 + bucket_text_length(len(text_to_seqvec(t, c)))
                   for t in chunks))
    for g, w in zip(got, want):
        assert g["mel"].shape == w["mel"].shape
        _close(torch.from_numpy(g["mel"]), torch.from_numpy(w["mel"]))


@pytest.mark.cuda
@pytest.mark.parametrize("encoder_type", ["gatedconv",
                                          "time-depth-separable"])
def test_glow_encoders_refuse_b3_on_the_card(cuda, encoder_type):
    """Glow-TTS with the gated-conv or separable encoder: inference on the
    card never launches B3 and matches the CPU (noise 0); a train-mode
    forward moves the separable encoder's running statistics alike."""
    from tts_tpu_torch.models.glow_tts import GlowTTS
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    from tts_tpu_torch.ops.glow_encoder import supports_fused_encoder
    kw = dict(num_chars=60, encoder_type=encoder_type,
              hidden_channels_enc=32, hidden_channels_dec=32,
              filter_channels=64, filter_channels_dp=48, num_layers_enc=2,
              num_flow_blocks_dec=2, num_block_layers=2)
    torch.manual_seed(0)
    cpu = GlowTTS(**kw).eval()
    assert not supports_fused_encoder(cpu.encoder)
    with torch.no_grad():     # pin the durations (ceil flips on an ulp)
        cpu.encoder.duration_predictor.proj.weight.zero_()
        cpu.encoder.duration_predictor.proj.bias.fill_(1.5)
    # weight norm's computed weights are not leaves: no deepcopy
    dev = GlowTTS(**kw)
    dev.load_state_dict(cpu.state_dict())
    dev.to(cuda).eval().store_inverse()
    text = torch.randint(1, 60, (2, 21), generator=torch.Generator()
                         .manual_seed(4))
    lengths = torch.tensor([21, 13])
    want = cpu.inference(text, lengths, noise_scale=0.0, y_max_length=96)
    before = build.LAUNCHES[GEK.KERNEL]
    got = dev.inference(text.to(cuda), lengths.to(cuda), noise_scale=0.0,
                        y_max_length=96)
    torch.cuda.synchronize()
    assert build.LAUNCHES[GEK.KERNEL] == before
    assert torch.equal(got["mel_lengths"].cpu(), want["mel_lengths"])
    _close(got["model_outputs"], want["model_outputs"])
    for m in (cpu, dev):
        m.encoder.train()
        for drop in m.modules():
            if hasattr(drop, "rate"):
                drop.rate = 0.0
    with torch.no_grad():
        _close(dev.encoder(text.to(cuda), lengths.to(cuda))[0],
               cpu.encoder(text, lengths)[0])
    stats = dict(cpu.named_buffers())
    for name, a in dev.named_buffers():
        if ".running_" in name:
            _close(a, stats[name])


def _small_wavernn(mode="bits"):
    """WaveRNN at rnn and fc 64, 2 res blocks, upsample (4, 4), 9 bits or
    4 mixtures, seeded, with seeded BatchNorm statistics (eval mode)."""
    from tts_tpu_torch.models.vocoder.wavernn import WaveRNN
    torch.manual_seed(0)
    gen = WaveRNN(bits=9, rnn_dims=64, fc_dims=64, compute_dims=32,
                  res_out_dims=32, res_blocks=2, upsample_factors=(4, 4),
                  mode=mode, nr_mix=4)
    for name, buf in gen.named_buffers():
        if name.endswith("running_var"):
            buf.uniform_(0.5, 1.5)
        elif name.endswith("running_mean"):
            buf.normal_(0.0, 0.1)
    return gen.eval()


@pytest.mark.cuda
def test_wavernn_generate_makes_no_host_sync_per_sample(cuda):
    """``generate`` on the card: the host's waits on the card and the
    copies between host and card of one call (torch.profiler's
    synchronization events and its HtoD / DtoH memcpy activity; a
    device-to-device copy makes the host wait for nothing) do not grow
    with the number of samples."""
    from torch.profiler import ProfilerActivity, profile
    gen = _small_wavernn().to(cuda)
    counts = {}
    for frames in (4, 12):
        mel = torch.randn(1, 80, frames + 2 * gen.pad, device=cuda)
        gen.generate(mel, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wav = gen.generate(mel, torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
        assert wav.shape == (1, frames * gen.hop) and wav.is_cuda
        counts[frames] = {
            e.key: e.count for e in prof.key_averages()
            if e.key.startswith(("Memcpy HtoD", "Memcpy DtoH",
                                 "cudaStreamSynchronize",
                                 "cudaDeviceSynchronize",
                                 "cudaEventSynchronize"))}
    assert counts[4] == counts[12], counts
    assert sum(counts[4].values()) <= 4, counts


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bits", "mold"])
def test_wavernn_card_samples_against_the_cpu(cuda, mode):
    """The samples drawn on the card, fed back teacher-forced: the logits
    on the card and on the CPU agree (1e-4 of the largest), and the CPU's
    logits at the same uniforms draw the card's samples, except where a
    uniform lies within 1e-5 of a class boundary."""
    from tts_tpu_torch.models.vocoder import wavernn as W
    cpu = _small_wavernn(mode)
    gen = _small_wavernn(mode).to(cuda)
    mel = torch.randn(1, 80, 20 + 2 * gen.pad,
                      generator=torch.Generator().manual_seed(1))
    T = 20 * gen.hop
    u = gen.draws(1, T, torch.Generator().manual_seed(0), cuda)
    samples = gen.sample_loop(mel.to(cuda), u)
    x_in = gen.previous_samples(samples)
    with torch.no_grad():
        got = gen(x_in, mel.to(cuda)).cpu()
        want = cpu(x_in.cpu(), mel)
    _close(got, want)
    u, samples = u.cpu(), samples.cpu()
    if mode == "bits":
        differ = W.draw_bits(want, u[0]) != samples
        near = W.boundary_distance(want, u[0]) < 1e-5
    else:
        differ = (W.draw_mold(want, u[0], u[1]) - samples).abs() > 1e-4
        near = W.boundary_distance(want[..., :4], u[0]) < 1e-5
    assert not bool((differ & ~near).any()), int(differ.sum())


@pytest.mark.cuda
def test_exported_programs_match_the_kernel_path(cuda, tmp_path):
    """A Multiband-MelGAN and a small Glow-TTS exported on the CPU
    (``export/deploy.py``), loaded and run on the card: the vocoder against
    the megakernel chain (B1/B2), Glow-TTS against its inference through
    B3, each within 1e-4 of the largest magnitude."""
    from tts_tpu_torch.bin.export_model import TTSProgram, VocoderProgram
    from tts_tpu_torch.export import (export_program, load_program,
                                      run_program)
    from tts_tpu_torch.models.glow_tts import GlowTTS
    from tts_tpu_torch.models.weight_norm import remove_weight_norm
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    torch.manual_seed(0)
    gen = MultibandMelganGenerator(base_channels=384, num_res_blocks=4,
                                   use_weight_norm=False).eval()
    mel = torch.randn(2, 37, 80)
    export_program(VocoderProgram(gen), (mel,), str(tmp_path / "voc.pt2"))
    got = run_program(load_program(str(tmp_path / "voc.pt2")), mel,
                      device=cuda)
    want = M.megakernel_inference(
        gen, M.pack_generator_params(gen, gen.state_dict(), cuda),
        mel.to(cuda))[..., 0]
    _close(got, want)

    kw = dict(num_chars=60, hidden_channels_enc=32, hidden_channels_dec=32,
              filter_channels=64, filter_channels_dp=48, num_layers_enc=2,
              num_flow_blocks_dec=2, num_block_layers=2)
    cpu = GlowTTS(**kw).eval()
    with torch.no_grad():     # pin the durations (ceil flips on an ulp)
        cpu.encoder.duration_predictor.proj.weight.zero_()
        cpu.encoder.duration_predictor.proj.bias.fill_(1.5)
    card = GlowTTS(**kw)
    card.load_state_dict(cpu.state_dict())
    card.to(cuda).eval().store_inverse()
    remove_weight_norm(cpu).store_inverse()
    text = torch.randint(1, 60, (1, 21), generator=torch.Generator()
                         .manual_seed(4))
    lengths = torch.tensor([17], dtype=torch.int32)
    export_program(TTSProgram(cpu, 96), (text, lengths),
                   str(tmp_path / "glow.pt2"))
    got = run_program(load_program(str(tmp_path / "glow.pt2")), text,
                      lengths, device=cuda)
    before = build.LAUNCHES[GEK.KERNEL]
    want = card.inference(text.to(cuda), lengths.to(cuda), noise_scale=0.0,
                          y_max_length=96)["model_outputs"]
    assert build.LAUNCHES[GEK.KERNEL] > before
    _close(got, want)


@pytest.mark.cuda
def test_eval_model_runs_b4_and_b7_on_the_card(cuda, tmp_path):
    """``bin/eval_model`` on the card: Glow-TTS's alignment is one MAS
    launch a batch, Tacotron2's encoder 1 + the text bucket BiLSTM launches
    a batch; the metrics equal the CPU's within 1e-4 relative."""
    import json
    import os

    from chip_smoke import write_corpus
    from tts_tpu_torch.bin.eval_model import evaluate
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.text import num_symbols
    corpus = write_corpus(str(tmp_path / "lj"), 8)
    for name, small in (
            ("glow_tts_ljspeech", dict(hidden_channels_encoder=32,
                                       hidden_channels_decoder=32)),
            ("tacotron2_ljspeech", dict(encoder_dim=64, embedding_dim=64,
                                        attn_dim=32))):
        c = load_config(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", f"{name}.json"))
        c.update(small)
        c["datasets"] = [{"name": "ljspeech", "path": corpus,
                          "meta_file_train": "metadata.csv",
                          "meta_file_val": "metadata.csv"}]
        cfg = tmp_path / f"{name}.json"
        cfg.write_text(json.dumps(c))
        torch.manual_seed(0)
        model = setup_model(num_symbols(c["use_phonemes"]), 1, c)
        ckpt = tmp_path / f"{name}.pt"
        torch.save({"model": model.state_dict()}, ckpt)
        build.reset_launches()
        got = evaluate(str(cfg), str(ckpt), num_items=8, device=cuda)
        launches = dict(build.LAUNCHES)
        want = evaluate(str(cfg), str(ckpt), num_items=8, device="cpu")
        if name.startswith("glow"):
            assert launches == {MAS.KERNEL: 1}, launches
        else:
            assert set(launches) == {BLK.KERNEL}, launches
            assert launches[BLK.KERNEL] > 1 and launches[BLK.KERNEL] % 32 == 1
        for key, value in want.items():
            if isinstance(value, float):
                assert abs(got[key] - value) <= 1e-4 * max(abs(value), 1e-6), \
                    (key, got[key], value)


# ---------------------------------------------------------------------------
# the data-parallel layer on the card (chip_smoke.py's phase 30 helpers:
# full-width models from the repo's configs, fp32, one length per batch)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_world_of_one(cuda, tmp_path):
    from tts_tpu_torch.parallel import make_mesh
    from tts_tpu_torch.parallel.mesh import finalize, initialize_multihost
    initialize_multihost(f"file://{tmp_path}/store", 1, 0, backend="nccl")
    try:
        yield make_mesh()
    finally:
        finalize()


@pytest.mark.cuda
def test_dp_steps_at_an_nccl_world_of_one_equal_the_single_step(
        cuda, nccl_world_of_one):
    """The Glow-TTS and Tacotron2 DP steps over NCCL (a world of one)
    against the single-process step: the total loss rtol 1e-5, every tensor
    atol 1e-6 rtol 1e-4 (tts_tpu's), the same launches (Glow: B4 for the
    DDI pass and the step)."""
    from chip_smoke import dp_compare, dp_inputs, dp_run
    inputs = dp_inputs(("glow", "taco"))
    single = dp_run(inputs, cuda)
    summary = dp_compare([dp_run(inputs, cuda, nccl_world_of_one)], single)
    assert single["glow"]["launches"] == {MAS.KERNEL: 2}
    assert set(summary) == {"glow", "taco"}


@pytest.mark.cuda
def test_gan_dp_step_at_a_gloo_world_of_two_on_one_card(cuda, tmp_path):
    """Multiband-MelGAN's GAN step (batch 4 x 16,384, 2 a rank) at a gloo
    world of 2 on this card against the single-process step; each rank
    launches B5 12 times and B6 27 + 18 times, as one process does."""
    import os

    from chip_smoke import dp_compare, dp_inputs, dp_run, spawn_dp_ranks
    inputs = dp_inputs(("gan",), gan_batch=4)
    torch.save(inputs, os.path.join(tmp_path, "inputs.pt"))
    ranks = spawn_dp_ranks(str(tmp_path), timeout_s=300)
    single = dp_run(inputs, cuda)
    dp_compare(ranks, single)
    assert single["gan"]["launches"] == {SK.KERNEL: 12, GCK.DGRAD: 27,
                                         GCK.WGRAD: 18}


@pytest.mark.cuda
def test_dp_serving_launches_b1_b2_b3(cuda, nccl_world_of_one):
    """make_dp_serving (NCCL, a world of one) of Glow-TTS -> MB-MelGAN at
    batch 8: the same launches of B3, B2 and B1 as the plain call, and the
    same audio within 1e-4 of its largest magnitude."""
    from chip_smoke import dp_inputs, dp_serve
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    inputs = dp_inputs(("serve",))
    want = dp_serve(inputs, cuda)["serve"]
    got = dp_serve(inputs, cuda, nccl_world_of_one)["serve"]
    assert got["launches"] == want["launches"]
    assert all(want["launches"].get(k, 0) > 0 for k in (
        R.KERNEL, M.PROJ_IN, M.UPSAMPLE, M.TAIL, GEK.KERNEL))
    _close(got["wav"], want["wav"])

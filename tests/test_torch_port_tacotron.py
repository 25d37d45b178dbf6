"""The port's Tacotron (v1) against tts_tpu's, on the CPU.

tts_tpu's Tacotron has fixed widths (embedding, encoder and decoder 256,
CBHG 128); the model here is cut in r (2, r_init 3), linear bins (65) and
text (16 and 11 symbols, ragged), with numpy-seeded weights and BatchNorm
statistics (``tests/test_torch_port_tacotron2.py::jax_variables``) carried
over by ``tacotron_state_dict_from_jax``. Each of the memory queue's three
branches runs: no queue (``memory_size`` -1), a queue no longer than r (2:
the oldest frames of the previous group) and a longer one (5).

Tolerances, float32 with another order of summation: module and model
outputs 1e-4 absolute (as the Tacotron2 tests); ``mel_lengths``, the
teacher-forced memory and the weights' round trip exactly; loss terms 1e-5
relative; gradients 1e-3 of each tensor's largest reference gradient and
parameters after one step 1e-3 of the largest update plus one float32
spacing (as ``test_torch_port_taco2_train.py``); BatchNorm's running
statistics after a train-mode update 1e-6.
"""

import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from tests.fixtures import make_ljspeech_fixture
from tests.test_torch_port_tacotron2 import jax_variables
from tests.torch_port_params import random_params
from tts_tpu.compat.torch_port import port_tacotron
from tts_tpu.losses import tts_losses as JL
from tts_tpu.models.tacotron import CBHG as JCBHG
from tts_tpu.models.tacotron import BatchNormConv1d as JBNConv
from tts_tpu.models.tacotron import Tacotron as JTacotron
from tts_tpu.train.optim import make_optimizer as j_make_optimizer
from tts_tpu.train.state import TrainState
from tts_tpu_torch.compat.from_jax import tacotron_state_dict_from_jax
from tts_tpu_torch.losses import tts_losses as L
from tts_tpu_torch.models.tacotron import CBHG, BatchNormConv1d, Tacotron
from tts_tpu_torch.train.optim import make_optimizer
from tts_tpu_torch.train.trainer_tts import forward, train_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
N_CHARS = 40
SMALL = dict(num_chars=N_CHARS, r=2, r_init=3, linear_dim=65)
LENGTHS = (16, 11)
STEPS = 12
# per memory size: a stopnet gain and bias that stop the two items at
# different steps (-1: steps 9 and 11; 2: 4 and 5; 5: item 1 at 6, item 0
# never), each logit at least 0.03 from the threshold
STOPS = {-1: (-30.0, 2.0), 2: (30.0, -5.93), 5: (-30.0, 2.2)}
MEMORY_SIZES = sorted(STOPS)
LOSS = dict(r=2, ga_alpha=5.0, use_linear=True)
OPT = dict(lr=1.0, grad_clip=1.0, weight_decay=0.01)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _np(t):
    return t.detach().numpy()


def _jmodel(memory_size, **kw):
    return JTacotron(memory_size=memory_size, max_decoder_steps=STEPS,
                     **SMALL, **kw)


@pytest.fixture(scope="module")
def variables():
    """One seeded tree per memory size (the prenet's input width differs)."""
    return {m: jax_variables(_jmodel(m)) for m in MEMORY_SIZES}


def _port(variables, memory_size, **kw) -> Tacotron:
    model = Tacotron(memory_size=memory_size, max_decoder_steps=STEPS,
                     **SMALL, **kw)
    model.load_state_dict(tacotron_state_dict_from_jax(*variables),
                          strict=True)
    return model.eval()


def _text(seed: int = 1):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, N_CHARS, (2, max(LENGTHS))).astype(np.int32)
    return text, np.asarray(LENGTHS, np.int32)


def _with_stops(params, memory_size):
    gain, bias = STOPS[memory_size]
    p = copy.deepcopy(params)
    stop = p["decoder"]["stopnet"]["linear"]
    stop["kernel"] = stop["kernel"] * gain
    stop["bias"] = np.full_like(stop["bias"], bias)
    return p


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4, 16])
def test_batchnorm_conv_pads_as_flax_same(k):
    """Odd and even kernels (SAME: (k - 1) // 2 before, k // 2 after), at
    eval and in train mode, where the running statistics move 0.01 of the
    way to the batch's (flax momentum 0.99), to the biased variance."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    jm = JBNConv(16, k, activation="relu")
    p = {"conv": {"kernel": (rng.standard_normal((k, 12, 16))
                             / np.sqrt(12 * k)).astype(np.float32)},
         "bn": {"scale": (1 + 0.1 * rng.standard_normal(16)).astype("f4"),
                "bias": (0.1 * rng.standard_normal(16)).astype("f4")}}
    s = {"bn": {"mean": (0.1 * rng.standard_normal(16)).astype("f4"),
                "var": (0.5 + rng.random(16)).astype("f4")}}
    block = BatchNormConv1d(12, 16, k, "relu")
    block.conv1d.weight.data = torch.from_numpy(
        np.ascontiguousarray(p["conv"]["kernel"].transpose(2, 1, 0)))
    block.bn.weight.data = torch.from_numpy(p["bn"]["scale"])
    block.bn.bias.data = torch.from_numpy(p["bn"]["bias"])
    block.bn.running_mean.copy_(torch.from_numpy(s["bn"]["mean"]))
    block.bn.running_var.copy_(torch.from_numpy(s["bn"]["var"]))
    xt = torch.from_numpy(x).transpose(1, 2)
    want = jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x), False)
    with torch.no_grad():
        got = block.eval()(xt)
    np.testing.assert_allclose(_np(got.transpose(1, 2)), np.asarray(want),
                               atol=ATOL)
    want, mutated = jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                             True, mutable=["batch_stats"])
    with torch.no_grad():
        got = block.train()(xt)
    np.testing.assert_allclose(_np(got.transpose(1, 2)), np.asarray(want),
                               atol=ATOL)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            _np(getattr(block.bn, ours)),
            np.asarray(mutated["batch_stats"]["bn"][theirs]), atol=1e-6)


def test_cbhg_with_even_kernels_and_pre_highway(variables):
    """tts_tpu's post-net CBHG (K 8: kernels 1-8, projections (256, 80),
    the pre-highway projection, highways, the bidirectional GRU) on the
    seeded weights, over a whole padded sequence."""
    params, stats = variables[-1]
    x = np.random.default_rng(3).standard_normal((2, 13, 80)).astype("f4")
    want = jax.jit(JCBHG(80, K=8, conv_projections=(256, 80)).apply,
                   static_argnums=2)(
        {"params": params["postnet"]["cbhg"],
         "batch_stats": stats["postnet"]["cbhg"]}, jnp.asarray(x), False)
    model = _port(variables[-1], -1)
    assert isinstance(model.postnet.cbhg, CBHG)
    assert [c.conv1d.kernel_size[0]
            for c in model.postnet.cbhg.conv1d_banks] == list(range(1, 9))
    with torch.no_grad():
        got = model.postnet(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("memory_size", MEMORY_SIZES)
def test_teacher_forced_forward_matches(variables, memory_size):
    """The memory of each queue branch exactly, then the whole
    teacher-forced pass (train=False: no dropout, running statistics)."""
    params, stats = variables[memory_size]
    jm = _jmodel(memory_size)
    text, lengths = _text()
    mel = np.random.default_rng(2).standard_normal((2, 12, 80)).astype("f4")
    mem = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(mel),
                   method=JTacotron._memory_inputs)
    model = _port(variables[memory_size], memory_size)
    np.testing.assert_array_equal(
        _np(model.memory_inputs(torch.from_numpy(mel))),
        np.swapaxes(np.asarray(mem), 0, 1))
    want = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(text),
        jnp.asarray(lengths), jnp.asarray(mel))
    with torch.no_grad():
        got = model(torch.from_numpy(text).long(), torch.from_numpy(lengths),
                    torch.from_numpy(mel))
    assert got["postnet_outputs"].shape == (2, 12, 65)
    for key in ("decoder_outputs", "postnet_outputs", "alignments",
                "stop_logits"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]),
                                   atol=ATOL, err_msg=key)


@pytest.mark.parametrize("memory_size", MEMORY_SIZES)
def test_inference_matches_with_mixed_stops(variables, memory_size):
    """The greedy decode over 12 steps at the default windowing flag, the
    two items stopping at different steps (ragged text: the CBHG reads
    the pads, as tts_tpu's does): every output within 1e-4 and
    ``mel_lengths`` exactly."""
    params, stats = variables[memory_size]
    params = _with_stops(params, memory_size)
    text, lengths = _text()
    jm = _jmodel(memory_size)
    want = jax.jit(lambda v, *a: jm.apply(v, *a, method=JTacotron.inference))(
        {"params": params, "batch_stats": stats}, jnp.asarray(text),
        jnp.asarray(lengths))
    got = _port((params, stats), memory_size).inference(
        torch.from_numpy(text).long(), torch.from_numpy(lengths))
    lengths_out = np.asarray(want["mel_lengths"])
    assert lengths_out[0] != lengths_out[1], lengths_out
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), lengths_out)
    for key in ("decoder_outputs", "postnet_outputs", "alignments",
                "stop_logits"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]),
                                   atol=ATOL, err_msg=key)


def test_speaker_and_style_conditioning_matches():
    """A 3-speaker Tacotron with GST (tts_tpu's speaker table of 256 and
    GST of 256 concatenated after the encoder): the decode with a speaker
    id and a style mel."""
    kw = dict(num_speakers=3, use_gst=True)
    jm = _jmodel(5, stop_threshold=2.0, **kw)
    key = jax.random.PRNGKey(0)
    shapes = unfreeze(jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 8), jnp.int32),
        jnp.array([8]), jnp.zeros((1, 12, 80)), jnp.array([12]),
        speaker_ids=jnp.zeros((1,), jnp.int32))))
    rng = np.random.default_rng(4)
    params = random_params(shapes["params"], rng)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (0.5 + np.abs(rng.standard_normal(leaf.shape))
                            if path[-1].key == "var"
                            else 0.1 * rng.standard_normal(leaf.shape)
                            ).astype(np.float32), shapes["batch_stats"])
    model = _port((params, stats), 5, stop_threshold=2.0, **kw)
    assert model.decoder.attention_rnn.input_size == 128 + 256 * 3
    text, lengths = _text()
    ids = np.array([2, 0], np.int32)
    style = np.random.default_rng(6).standard_normal((2, 23, 80)).astype("f4")
    want = jax.jit(lambda v, *a: jm.apply(v, *a, method=JTacotron.inference))(
        {"params": params, "batch_stats": stats}, jnp.asarray(text),
        jnp.asarray(lengths), jnp.asarray(ids), jnp.asarray(style))
    got = model.inference(torch.from_numpy(text).long(),
                          torch.from_numpy(lengths), torch.from_numpy(ids),
                          torch.from_numpy(style))
    for key in ("decoder_outputs", "postnet_outputs", "alignments",
                "stop_logits"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]),
                                   atol=ATOL, err_msg=key)


def test_weights_round_trip_through_port_tacotron(variables):
    """The port's state dict, read by tts_tpu's ``port_tacotron`` (Mozilla
    -> flax), gives back the seeded params and statistics exactly."""
    params, stats = variables[5]
    sd = {k: v.numpy() for k, v in
          _port(variables[5], 5).state_dict().items()}
    p2, s2 = port_tacotron(sd)
    flat = jax.tree_util.tree_leaves_with_path
    want = dict(flat({"params": params, "batch_stats": stats}))
    got = dict(flat({"params": p2, "batch_stats": s2}))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf), err_msg=str(path))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch():
    rng = np.random.default_rng(11)
    mel_lengths = np.array([12, 9], np.int32)
    stop = np.zeros((2, 12), np.float32)
    for b, n in enumerate(mel_lengths):
        stop[b, n - 1:] = 1.0
    return {"text": _text()[0], "text_lengths": np.asarray(LENGTHS, np.int32),
            "mel": rng.standard_normal((2, 12, 80)).astype(np.float32),
            "linear": rng.standard_normal((2, 12, 65)).astype(np.float32),
            "mel_lengths": mel_lengths,
            "stop_targets": stop.reshape(2, 6, 2).max(-1)}


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["text"] = out["text"].long()
    return out


@pytest.mark.parametrize("use_linear", [True, False])
def test_loss_postnet_target(use_linear):
    """``use_linear``: the post-net's L1 is against ``batch["linear"]``;
    without it against the mel (a post-net of mel width)."""
    rng = np.random.default_rng(5)
    batch = _batch()
    width = 65 if use_linear else 80
    out = {"decoder_outputs": rng.standard_normal((2, 12, 80)),
           "postnet_outputs": rng.standard_normal((2, 12, width)),
           "alignments": rng.random((2, 6, 16)),
           "stop_logits": rng.standard_normal((2, 6))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    kw = dict(LOSS, use_linear=use_linear)
    want = jax.jit(lambda o, b: JL.tacotron_loss(o, b, **kw))(
        {k: jnp.asarray(v) for k, v in out.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = L.tacotron_loss({k: torch.from_numpy(v) for k, v in out.items()},
                          _torch_batch(batch), **kw)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)


def _jax_optimizer_step(params, grads):
    """tts_tpu's optimizer chain through ``TrainState.apply_gradients`` on
    the parameters packed into two leaves, the rank >= 2 kernels (decayed
    by ``_decay_mask``) and the rest: the chain is elementwise but for the
    global norm, which packing keeps, and two leaves compile in a fraction
    of the time the model's 210 take."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    kernels = [i for i, leaf in enumerate(leaves) if leaf.ndim >= 2]
    others = [i for i in range(len(leaves)) if i not in kernels]

    def pack(tree_):
        flat = [np.ravel(leaf) for leaf in jax.tree_util.tree_leaves(tree_)]
        return {"kernels": np.concatenate([flat[i] for i in kernels])[None],
                "others": np.concatenate([flat[i] for i in others])}

    state = TrainState.create(apply_fn=None, params=pack(params),
                              tx=j_make_optimizer(**OPT))
    new = jax.jit(lambda s, g: s.apply_gradients(grads=g).params)(
        state, pack(grads))
    out, starts = list(leaves), {"kernels": 0, "others": 0}
    for part, idx in (("kernels", kernels), ("others", others)):
        flat = np.asarray(new[part]).ravel()
        for i in idx:
            n = leaves[i].size
            out[i] = flat[starts[part]:starts[part] + n].reshape(
                leaves[i].shape)
            starts[part] += n
    return jax.tree_util.tree_unflatten(tree, out)


def test_train_step_matches_tts_tpu_step(variables):
    """One step with ``use_linear`` (train=False on both sides: no
    dropout, running statistics), memory queue 5, against what tts_tpu's
    ``make_train_step`` computes (its loss, ``jax.grad``, then its
    optimizer chain, ``_jax_optimizer_step``): the losses, every gradient
    and every parameter after the update."""
    params, stats = variables[5]
    jm = _jmodel(5)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out = jm.apply({"params": p, "batch_stats": stats}, jb["text"],
                       jb["text_lengths"], jb["mel"], jb["mel_lengths"],
                       train=False)
        losses = JL.tacotron_loss(out, jb, **LOSS)
        return losses["loss"], losses

    grads, j_losses = jax.jit(jax.grad(loss_fn, has_aux=True))(params)

    def as_port(tree):
        return {k: v.numpy() for k, v in
                tacotron_state_dict_from_jax(tree, stats).items()}

    old, new = as_port(params), as_port(_jax_optimizer_step(params, grads))
    grad = as_port(jax.tree_util.tree_map(np.asarray, grads))

    model = _port(variables[5], 5)
    opt = make_optimizer(model, **OPT)
    optimizer_step = opt.step
    seen = {}

    def step_and_record():
        seen.update({n: _np(p.grad) for n, p in model.named_parameters()
                     if p.grad is not None})
        optimizer_step()

    opt.step = step_and_record
    losses = train_step(model, opt, _torch_batch(batch), dict(LOSS))
    assert set(losses) == set(j_losses)
    for key, value in losses.items():
        np.testing.assert_allclose(value, float(j_losses[key]), rtol=1e-5,
                                   err_msg=key)
    for name, p in model.named_parameters():
        scale = float(np.abs(grad[name]).max())
        np.testing.assert_allclose(seen[name], grad[name], rtol=0,
                                   atol=1e-3 * scale, err_msg=name)
        atol = (1e-3 * float(np.abs(new[name] - old[name]).max())
                + float(np.spacing(np.abs(new[name]).max())))
        np.testing.assert_allclose(_np(p), new[name], rtol=0, atol=atol,
                                   err_msg=name)


def test_bfloat16_forward_matches_tts_tpu(variables):
    """The mixed-precision forward against tts_tpu's (``make_train_step``'s
    casts: bfloat16 parameters and mel). flax's GRU carries are float32,
    so from the CBHG encoder's GRU on tts_tpu computes in float32 on the
    bfloat16-rounded weights: the decoder (but its prenet, which reads the
    bfloat16 mel), the post-net and the linear head. Each output within
    3e-3 of the reference's norm: the two bfloat16 encoders round in their
    own order (3e-3 to 6e-3 apart inside, 2.0e-3 / 4.6e-4 / 1.0e-4 / 2.1e-3
    on the decoder, post-net, alignments and stop logits), where a decoder
    and post-net kept in bfloat16 are 5.3e-3 / 4.5e-3 / 6.0e-4 / 7.2e-3
    away."""
    from tts_tpu.train.state import _cast_floats

    params, stats = variables[5]
    jm = _jmodel(5)
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    want = jax.jit(lambda p: _cast_floats(jm.apply(
        {"params": _cast_floats(p, jnp.bfloat16), "batch_stats": stats},
        jb["text"], jb["text_lengths"], jb["mel"].astype(jnp.bfloat16),
        jb["mel_lengths"], train=False), jnp.float32))(params)
    with torch.no_grad():
        got = forward(_port(variables[5], 5), _torch_batch(_batch()),
                      torch.bfloat16)
    for key in ("decoder_outputs", "postnet_outputs", "alignments",
                "stop_logits"):
        assert got[key].dtype == torch.float32, key
        ref = np.asarray(want[key])
        rel = np.linalg.norm(_np(got[key]) - ref) / np.linalg.norm(ref)
        assert rel < 3e-3, (key, rel)


def test_gru_rz_hidden_bias_stays_zero_in_training(variables):
    """flax's GRUCell has no hidden-side r/z bias: after a step the r and
    z thirds of every GRU's ``bias_hh`` are still zero, the n third moved."""
    model = _port(variables[-1], -1).train()
    model.set_generator(torch.Generator().manual_seed(0))
    opt = make_optimizer(model, **OPT)
    train_step(model, opt, _torch_batch(_batch()), dict(LOSS))
    for name, p in model.named_parameters():
        if "bias_hh" in name:
            H = p.shape[0] // 3
            assert torch.count_nonzero(p[:2 * H]) == 0, name
            assert float(p.grad[2 * H:].abs().max()) > 0, name


# ---------------------------------------------------------------------------
# data, trainer, serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_ljspeech_fixture(str(tmp_path_factory.mktemp("ljs")))


def test_collate_linear_spectrogram_matches_tts_tpu(corpus):
    """``compute_linear_spec``: the batch's ``linear`` (B, T_mel, n_freq),
    padded as the mel, equals tts_tpu's collate."""
    from tts_tpu.audio import AudioProcessor as JAP
    from tts_tpu.data import TTSDataset as JDS
    from tts_tpu.data import load_meta_data as j_meta
    from tts_tpu_torch.audio import AudioProcessor
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.data import TTSDataset, load_meta_data

    c = load_config(os.path.join(ROOT, "configs", "tacotron2_ljspeech.json"))
    ds_cfg = [{"name": "ljspeech", "path": corpus,
               "meta_file_train": "metadata.csv"}]
    items, _ = load_meta_data(ds_cfg)
    j_items, _ = j_meta(ds_cfg)
    kw = dict(outputs_per_step=7, compute_linear_spec=True,
              use_phonemes=False)
    got = TTSDataset(AudioProcessor(**c["audio"]), items, **kw)
    want = JDS(JAP(**c["audio"]), j_items, **kw)
    gb = got.collate([got[i] for i in range(3)])
    wb = want.collate([want[i] for i in range(3)])
    assert gb["linear"].shape == (3, gb["mel"].shape[1],
                                  c["audio"]["fft_size"] // 2 + 1)
    for key in ("mel", "linear", "mel_lengths", "stop_targets"):
        np.testing.assert_allclose(gb[key], wb[key], atol=1e-5, err_msg=key)


def _v1_config(tmp_path, corpus):
    from tts_tpu_torch.config import load_config
    c = load_config(os.path.join(ROOT, "configs", "tacotron2_ljspeech.json"))
    c.update(model="tacotron", attention_norm="sigmoid", memory_size=5,
             double_decoder_consistency=False, mixed_precision=False,
             use_phonemes=False, epochs=2, test_delay_epochs=0,
             print_step=1, max_decoder_steps=6,
             gradual_training=[[0, 7, 4], [1, 3, 4]],
             test_sentences=["Be a voice, not an echo.", "BAD SENTENCE.",
                             "Hello there."])
    c["datasets"] = [{"name": "ljspeech", "path": corpus,
                      "meta_file_train": "metadata.csv"}]
    c["phoneme_cache_path"] = str(tmp_path / "phonemes")
    path = tmp_path / "tacotron.json"
    path.write_text(json.dumps(c))
    return c, str(path)


def test_trainer_trains_tacotron_and_survives_a_failing_sentence(
        corpus, tmp_path, monkeypatch, capsys):
    """bin/train_tts on the CPU with ``model`` "tacotron" (memory queue 5,
    sigmoid norm, gradual r 7 -> 3): the batches carry the linear target,
    every loss is finite, the post-net loss reads the linear bins. One test
    sentence raises (C24): it is reported, the others still give
    Griffin-Lim audio, and the final checkpoint is written and serves
    through the Synthesizer at the trained r."""
    from tts_tpu_torch.bin.train_tts import main
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.train import trainer_tts
    from tts_tpu_torch.train.checkpoint import latest_checkpoint

    c, cfg = _v1_config(tmp_path, corpus)
    real = trainer_tts.synthesis

    def synthesis(model, sentence, *args, **kwargs):
        if sentence == "BAD SENTENCE.":
            raise RuntimeError("made to fail")
        return real(model, sentence, *args, **kwargs)

    monkeypatch.setattr(trainer_tts, "synthesis", synthesis)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    trainer = main(["--config_path", cfg, "--output_path",
                    str(tmp_path / "runs"), "--device", "cpu"])
    assert isinstance(trainer.model, Tacotron)
    assert [s["r"] for s in trainer.step_stats] == [7, 3]
    for stats in trainer.step_stats:
        assert all(np.isfinite(v) for v in stats.values()), stats
    assert " [!] test sentence failed: made to fail" in capsys.readouterr().out
    audios = trainer.test_run()
    assert sorted(audios) == ["test_0", "test_2"]
    assert all(np.isfinite(a).all() and len(a) > 0 for a in audios.values())
    ckpt = latest_checkpoint(trainer.output_path)
    assert torch.load(ckpt, weights_only=True)["r"] == 3
    synth = Synthesizer(ckpt, cfg, device="cpu")
    assert synth.model.r == 3
    wav = synth.tts("Be a voice.")
    assert np.isfinite(wav).all() and len(wav) > 10000


def test_served_tacotron_refuses_a_mel_vocoder_as_tts_tpu_cannot_use_one(
        tmp_path):
    """C26: a linear spectrogram (513 bins) handed to a mel vocoder. tts_tpu
    hands it over and its generator fails on the channel count; the port
    refuses the pair at load with ValueError."""
    from tts_tpu.models.vocoder.registry import \
        setup_generator as j_setup_generator
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.text import num_symbols

    vc = load_config(os.path.join(ROOT, "configs", "multiband_melgan.json"))
    gen = j_setup_generator(vc)
    shapes = jax.eval_shape(lambda: gen.init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 32, 80))))
    variables = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                       shapes)
    with pytest.raises(Exception, match="shape"):
        gen.apply(variables, jnp.zeros((1, 32, 513)))

    c = load_config(os.path.join(ROOT, "configs", "tacotron2_ljspeech.json"))
    c.update(model="tacotron", memory_size=5)
    cfg = tmp_path / "tacotron.json"
    cfg.write_text(json.dumps(c))
    model = setup_model(num_symbols(c["use_phonemes"]), 1, c)
    assert model.last_linear.out_features == 513
    ckpt = tmp_path / "tacotron.pt"
    torch.save({"model": model.state_dict()}, ckpt)
    with pytest.raises(ValueError, match="linear spectrogram of 513 bins"):
        Synthesizer(str(ckpt), str(cfg), str(tmp_path / "unused.pt"),
                    os.path.join(ROOT, "configs", "multiband_melgan.json"),
                    device="cpu")

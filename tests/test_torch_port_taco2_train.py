"""Tacotron2 training in the port against tts_tpu, on the CPU.

The reduced model of ``test_torch_port_tacotron2.py`` (embedding and
encoder 64, attention 32, r 2 with r_init 3; the 1024-wide decoder LSTMs
are fixed in tts_tpu) with double decoder consistency (``ddc_r`` 3) and the
backward decoder, numpy-seeded weights and BatchNorm statistics carried
over by ``tacotron2_state_dict_from_jax``, ragged text and mel lengths,
TF32 off. The teacher-forced comparisons run both sides without dropout and
with the running statistics (tts_tpu ``train=False``, the port in
``eval()`` mode): the port's forward under no grad takes the BiLSTM's plain
kernel version, with grad the ``nn.LSTM`` path. Tolerances, float32 with
another order of summation:

- loss terms on seeded outputs: 1e-5 relative;
- teacher-forced outputs: 1e-4 absolute (as the eval tests);
- gradients: 1e-3 of the largest reference gradient of each tensor
  (backward through 6 teacher-forced steps of three decoders and the
  BiLSTM);
- parameters after one step: 1e-3 of the largest reference update of each
  tensor, plus one float32 spacing at the tensor's largest magnitude (each
  side rounds parameter + update to float32 on its own); learning rate 1,
  so that the updates stand well above that rounding;
- the bfloat16 forward against tts_tpu's float32 one: the decoder's and
  the postnet's outputs apart by 2^-12 to 5e-2 of the reference's norm
  (above an eighth of bfloat16's unit roundoff, so a forward that stayed
  float32 fails);
- a ConvBN block in train mode: outputs 1e-4, running statistics 1e-6;
- the gradual-training schedule and the dropout sites: exactly.

The trainer, its CLI and the Synthesizer's prewarm are
``test_torch_port_taco2_trainer.py``'s.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from tests.test_torch_port_tacotron2 import N_CHARS, SMALL, jax_variables
from tts_tpu.losses import tts_losses as JL
from tts_tpu.models.layers import ConvBNBlock as JConvBN
from tts_tpu.models.tacotron2 import DecoderCell as JDecoderCell
from tts_tpu.models.tacotron2 import Tacotron2 as JTacotron2
from tts_tpu.train.optim import gradual_training_schedule as j_schedule
from tts_tpu.train.optim import make_optimizer as j_make_optimizer
from tts_tpu.train.state import TrainState, make_train_step
from tts_tpu_torch.compat.from_jax import tacotron2_state_dict_from_jax
from tts_tpu_torch.losses import tts_losses as L
from tts_tpu_torch.models.dropout import Dropout
from tts_tpu_torch.models.tacotron2 import Tacotron2
from tts_tpu_torch.train.optim import gradual_training_schedule, \
    make_optimizer
from tts_tpu_torch.train.trainer_tts import forward, train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(SMALL, double_decoder_consistency=True, ddc_r=3,
             bidirectional_decoder=True)
TEXT_LENGTHS, MEL_LENGTHS, T_MEL = (16, 11), (12, 9), 12
LOSS = dict(r=SMALL["r"], ga_alpha=5.0)
OPT = dict(lr=1.0, grad_clip=1.0, weight_decay=0.01)
GRAD_TOL, UPDATE_TOL = 1e-3, 1e-3
BF16_OUT_RANGE = (2.0 ** -12, 5e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _np(t):
    return t.detach().numpy()


def _stop_targets(mel_lengths, t_mel, r):
    stop = np.zeros((len(mel_lengths), t_mel), np.float32)
    for b, n in enumerate(mel_lengths):
        stop[b, n - 1:] = 1.0
    return stop.reshape(len(mel_lengths), t_mel // r, r).max(-1)


def _batch():
    rng = np.random.default_rng(11)
    text = rng.integers(1, N_CHARS, (2, max(TEXT_LENGTHS))).astype(np.int32)
    mel = rng.standard_normal((2, T_MEL, 80)).astype(np.float32)
    return {"text": text, "text_lengths": np.asarray(TEXT_LENGTHS, np.int32),
            "mel": mel, "mel_lengths": np.asarray(MEL_LENGTHS, np.int32),
            "stop_targets": _stop_targets(MEL_LENGTHS, T_MEL, SMALL["r"])}


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["text"] = out["text"].long()
    return out


@pytest.fixture(scope="module")
def jmodel():
    return JTacotron2(num_chars=N_CHARS, **MODEL)


@pytest.fixture(scope="module")
def variables(jmodel):
    return jax_variables(jmodel)


def _port(variables) -> Tacotron2:
    model = Tacotron2(num_chars=N_CHARS, **MODEL)
    model.load_state_dict(tacotron2_state_dict_from_jax(*variables))
    return model.eval()


def _jax_loss_fn(jmodel, stats, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out = jmodel.apply({"params": params, "batch_stats": stats},
                           jb["text"], jb["text_lengths"], jb["mel"],
                           jb["mel_lengths"], train=False)
        losses = JL.tacotron_loss(out, jb, **LOSS)
        return losses["loss"], (out, losses)

    return loss_fn


@pytest.fixture(scope="module")
def jax_grads(jmodel, variables):
    """tts_tpu's outputs, losses and parameter gradients, train=False."""
    params, stats = variables
    grads, (out, losses) = jax.jit(jax.grad(
        _jax_loss_fn(jmodel, stats, _batch()), has_aux=True))(params)
    return (jax.tree_util.tree_map(np.asarray, grads),
            {k: np.asarray(v) for k, v in out.items()},
            {k: float(v) for k, v in losses.items()})


def _as_port(tree, stats):
    """A tts_tpu params-shaped tree (gradients, updated parameters) under
    the port's parameter names."""
    return {k: v.numpy() for k, v in
            tacotron2_state_dict_from_jax(tree, stats).items()}


# ---------------------------------------------------------------------------
# (a) losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masking,seq_len_norm",
                         [(True, False), (True, True), (False, False)])
def test_loss_terms_match_tacotron_loss(masking, seq_len_norm):
    """Every term of tacotron_loss, with DDC (coarse steps fewer than the
    fine ones), the backward decoder, guided attention and both
    differential spectral terms on."""
    rng = np.random.default_rng(3)
    B, T, steps, coarse, T_in = 3, 12, 6, 4, 10
    f32 = np.float32

    def soft(*shape):
        x = np.exp(rng.standard_normal(shape))
        return (x / x.sum(-1, keepdims=True)).astype(f32)

    outputs = {"decoder_outputs": rng.standard_normal((B, T, 80)),
               "postnet_outputs": rng.standard_normal((B, T, 80)),
               "stop_logits": 3 * rng.standard_normal((B, steps)),
               "alignments": soft(B, steps, T_in),
               "coarse_decoder_outputs": rng.standard_normal((B, T, 80)),
               "coarse_alignments": soft(B, coarse, T_in),
               "backward_decoder_outputs": rng.standard_normal((B, T, 80))}
    outputs = {k: v.astype(f32) for k, v in outputs.items()}
    lengths = np.array([12, 7, 4], np.int32)
    batch = {"mel": rng.standard_normal((B, T, 80)).astype(f32),
             "mel_lengths": lengths,
             "text_lengths": np.array([10, 6, 3], np.int32),
             "stop_targets": _stop_targets(lengths, T, 2)}
    kw = dict(r=2, loss_masking=masking, seq_len_norm=seq_len_norm,
              ga_alpha=5.0, decoder_diff_spec_alpha=0.3,
              postnet_diff_spec_alpha=0.7)
    want = JL.tacotron_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            **kw)
    got = L.tacotron_loss({k: torch.from_numpy(v) for k, v in outputs.items()},
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          **kw)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    entropy = L.attention_entropy_loss(torch.from_numpy(outputs["alignments"]))
    np.testing.assert_allclose(
        float(entropy),
        float(JL.attention_entropy_loss(jnp.asarray(outputs["alignments"]))),
        rtol=1e-5)


# ---------------------------------------------------------------------------
# (b) - (d) the teacher-forced forward, its gradients, one step
# ---------------------------------------------------------------------------

def test_teacher_forced_forward_matches(variables, jax_grads):
    """Every output of the teacher-forced pass, train=False on both sides
    (the BiLSTM through its plain kernel version: no grad)."""
    _, want, want_losses = jax_grads
    model = _port(variables)
    batch = _torch_batch(_batch())
    with torch.no_grad():
        got = model(batch["text"], batch["text_lengths"], batch["mel"],
                    batch["mel_lengths"])
        losses = L.tacotron_loss(got, batch, **LOSS)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(_np(got[key]), want[key], atol=1e-4,
                                   err_msg=key)
    assert set(losses) == set(want_losses)
    for key, value in want_losses.items():
        np.testing.assert_allclose(float(losses[key]), value, rtol=1e-4,
                                   err_msg=key)


def test_bfloat16_forward_near_tts_tpu(variables, jax_grads):
    """The mixed-precision forward (bfloat16 copies of the parameters, a
    bfloat16 mel, float32 outputs) against tts_tpu's float32 one, train=False
    on both sides: the decoder's and the postnet's outputs are apart by
    more than float32 rounding and within bfloat16's order, a share of the
    reference's norm in BF16_OUT_RANGE."""
    _, want, _ = jax_grads
    got = forward(_port(variables), _torch_batch(_batch()), torch.bfloat16)
    lo, hi = BF16_OUT_RANGE
    for key in ("decoder_outputs", "postnet_outputs"):
        assert got[key].dtype == torch.float32, key
        rel = (np.linalg.norm(_np(got[key]) - want[key])
               / np.linalg.norm(want[key]))
        assert lo < rel < hi, (key, rel)


def test_bfloat16_forward_matches_tts_tpu_bfloat16(jmodel, variables):
    """The mixed-precision forward against tts_tpu's (``make_train_step``'s
    casts: bfloat16 parameters and mel). flax's LSTM carries are float32,
    so from the encoder's BiLSTM on tts_tpu computes in float32 on the
    bfloat16-rounded weights: the three decoders (but their prenets) and
    the postnet. Each output within 3e-3 of the reference's norm (measured
    1e-4 to 2.3e-3; decoders and postnet kept in bfloat16 are 4.0e-3 to
    4.7e-3 away on the frames and 4.3e-3 on the stop logits)."""
    from tts_tpu.train.state import _cast_floats

    params, stats = variables
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    want = jax.jit(lambda p: _cast_floats(jmodel.apply(
        {"params": _cast_floats(p, jnp.bfloat16), "batch_stats": stats},
        jb["text"], jb["text_lengths"], jb["mel"].astype(jnp.bfloat16),
        jb["mel_lengths"], train=False), jnp.float32))(params)
    got = forward(_port(variables), _torch_batch(_batch()), torch.bfloat16)
    assert set(got) == set(want)
    for key, value in want.items():
        ref = np.asarray(value)
        rel = np.linalg.norm(_np(got[key]) - ref) / np.linalg.norm(ref)
        assert rel < 3e-3, (key, rel)


def test_gradients_match_jax_grad(variables, jax_grads):
    """Every trained tensor's gradient, the encoder's LSTM among them (run
    through nn.LSTM with grad enabled; non-zero)."""
    grads, _, _ = jax_grads
    want = _as_port(grads, variables[1])
    model = _port(variables)
    batch = _torch_batch(_batch())
    out = model(batch["text"], batch["text_lengths"], batch["mel"],
                batch["mel_lengths"])
    L.tacotron_loss(out, batch, **LOSS)["loss"].backward()
    params = dict(model.named_parameters())
    trained = {n: p for n, p in params.items() if p.requires_grad}
    # the port's parameters that tts_tpu lacks (zero there) are held fixed
    fixed = {n for n in params if n not in trained}
    assert fixed and all(not want[n].any() for n in fixed)
    for name, p in trained.items():
        ref = want[name]
        got = np.zeros_like(ref) if p.grad is None else _np(p.grad)
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=GRAD_TOL * float(np.abs(ref).max()),
            err_msg=name)
    for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                 "weight_ih_l0_reverse", "weight_hh_l0_reverse",
                 "bias_ih_l0_reverse"):
        assert float(trained[f"encoder.lstm.{name}"].grad.abs().max()) > 0


def test_train_step_matches_tts_tpu_step(jmodel, variables):
    """One whole step (train=False: no dropout, running statistics) against
    make_train_step's, with gradient clipping and weight decay: every
    parameter after the update."""
    params, stats = variables
    state = TrainState.create(apply_fn=jmodel.apply, params=params,
                              batch_stats=stats, tx=j_make_optimizer(**OPT))
    step = make_train_step(jmodel, dict(LOSS), jit=True, train=False)
    batch = _batch()
    new_state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
    old = _as_port(params, stats)
    new = _as_port(jax.tree_util.tree_map(np.asarray, new_state.params),
                   stats)

    model = _port(variables)
    opt = make_optimizer(model, **OPT)
    train_step(model, opt, _torch_batch(batch), dict(LOSS))
    for name, p in model.named_parameters():
        atol = (UPDATE_TOL * float(np.abs(new[name] - old[name]).max())
                + float(np.spacing(np.abs(new[name]).max())))
        np.testing.assert_allclose(_np(p), new[name], rtol=0, atol=atol,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (e), (f) train-mode BatchNorm and dropout
# ---------------------------------------------------------------------------

def test_convbn_train_mode_matches_flax_batchnorm(variables):
    """A ConvBN block in train mode, dropout 0 on both sides: the output
    (batch statistics) and the running statistics after one update, whose
    variance is flax's biased one (torch's own BatchNorm1d would take
    N / (N - 1) of it)."""
    params, stats = variables
    p, s = params["encoder"]["conv_1"], stats["encoder"]["conv_1"]
    x = np.random.default_rng(2).standard_normal((2, 16, 64), np.float32)
    want, mutated = JConvBN(64, 5, activation="relu", dropout_rate=0.0).apply(
        {"params": p, "batch_stats": s}, jnp.asarray(x), train=True,
        mutable=["batch_stats"])
    block = _port(variables).encoder.convolutions[1]
    block.dropout.rate = 0.0
    block.train()
    got = block(torch.from_numpy(x).transpose(1, 2))
    np.testing.assert_allclose(_np(got.transpose(1, 2)), np.asarray(want),
                               atol=1e-4)
    bn = block.batch_normalization
    np.testing.assert_allclose(_np(bn.running_mean),
                               np.asarray(mutated["batch_stats"]["bn"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(_np(bn.running_var),
                               np.asarray(mutated["batch_stats"]["bn"]["var"]),
                               atol=1e-6)
    unbiased = torch.nn.BatchNorm1d(64, eps=1e-5)
    unbiased.running_var.copy_(torch.from_numpy(np.asarray(s["bn"]["var"])))
    unbiased.train()(block.convolution1d(torch.from_numpy(x).transpose(1, 2)))
    assert float((unbiased.running_var - bn.running_var).abs().max()) > 1e-3


def _decoder_inputs(rng, B=2, T=16):
    f32 = np.float32
    enc = rng.standard_normal((B, T, 64)).astype(f32)
    mask = np.arange(T)[None] < np.array(TEXT_LENGTHS)[:, None]
    return enc, mask, rng.standard_normal((B, 80)).astype(f32)


def test_decoder_dropout_sites_match(variables):
    """One train-mode decoder step: the dropout sites (shape, rate) equal
    DecoderCell's (the prenet's two, the query, the attention LSTM's cell
    state, the decoder output, the stopnet input); two runs from one
    generator seed give equal outputs, another seed other ones."""
    params, _ = variables
    enc, mask, memory = _decoder_inputs(np.random.default_rng(6))

    jdec = JDecoderCell(n_mels=80, r=2, r_init=3, encoder_dim=64,
                        attn_dim=32)
    jvars = {"params": params["decoder"]}
    pi = jdec.apply(jvars, jnp.asarray(enc),
                    method=lambda m, x: m.attention.preprocess_inputs(x))
    zeros = jnp.zeros((2, 1024))
    carry = {"inputs": jnp.asarray(enc), "processed_inputs": pi,
             "mask": jnp.asarray(mask), "attn_rnn": (zeros, zeros),
             "dec_rnn": (zeros, zeros),
             "attn_state": {"attention_weights": jnp.zeros((2, 16)),
                            "attention_cum": jnp.zeros((2, 16))},
             "context": jnp.zeros((2, 64))}
    want = []

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, fnn.Dropout) and context.method_name == "__call__":
            det = fnn.merge_param("deterministic", mod.deterministic,
                                  kwargs.get("deterministic"))
            if not det:
                want.append((tuple(args[0].shape), mod.rate))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        jdec.apply(jvars, carry, jnp.asarray(memory), False, False,
                   rngs={"dropout": jax.random.PRNGKey(1)})

    dec = _port(variables).decoder.train()
    got = []
    hooks = [m.register_forward_hook(
        lambda m, inp, out: got.append((tuple(inp[0].shape), m.rate)))
        for m in dec.modules() if isinstance(m, Dropout)]

    def run(seed):
        for m in dec.modules():
            if isinstance(m, Dropout):
                m.generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            e = torch.from_numpy(enc)
            c = dec.init_carry(e, torch.from_numpy(mask))
            new, outs = dec(c, torch.from_numpy(memory))
        return [*outs, *new["attn_rnn"], *new["dec_rnn"]]

    first = run(5)
    for h in hooks:
        h.remove()
    assert len(want) == 6
    assert sorted(got) == sorted(want)
    assert all(torch.equal(a, b) for a, b in zip(first, run(5)))
    assert not torch.equal(first[0], run(6)[0])


# ---------------------------------------------------------------------------
# (g) the gradual-training schedule
# ---------------------------------------------------------------------------

def test_gradual_training_schedule_matches():
    with open(os.path.join(ROOT, "configs", "tacotron2_ljspeech.json")) as f:
        from tts_tpu_torch.config import loads_config
        schedule = loads_config(f.read())["gradual_training"]
    for step in (0, 1, 4999, 5000, 9999, 10000, 25000, 49999, 50000,
                 10 ** 6):
        assert gradual_training_schedule(step, schedule) == \
            j_schedule(step, schedule, 1), step

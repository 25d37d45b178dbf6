"""The port's encoder BiLSTM (ops/bilstm.py, the B7 kernel's plain version on
the CPU) against tts_tpu's Pallas ``fused_bilstm`` in interpret mode and
against flax ``Bidirectional`` with ``seq_lengths``, on ragged lengths.

Tolerance: 1e-5 absolute (float32, the same fused cell; the two packages
sum the gate products in other orders). ``flip_sequences`` exactly.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.ops.pallas.fused_bilstm import flip_sequences as jflip
from tts_tpu.ops.pallas.fused_bilstm import fused_bilstm, pack_bilstm_params
from tts_tpu_torch.compat.from_jax import tacotron2_state_dict_from_jax
from tts_tpu_torch.models.layers import Encoder
from tts_tpu_torch.ops.bilstm import bilstm, bilstm_torch, flip_sequences

from tests.torch_port_params import module_params

torch.set_num_threads(1)

ATOL = 1e-5
B, T, C, H = 3, 12, 32, 16
LENGTH_SETS = {"ragged": (12, 8, 4), "full_and_one": (12, 12, 1)}


class _BiLSTM(nn.Module):
    """Tacotron2Encoder's construction (models/layers.py)."""

    @nn.compact
    def __call__(self, x, lengths):
        return nn.Bidirectional(
            nn.RNN(nn.OptimizedLSTMCell(H), name="lstm_fwd"),
            nn.RNN(nn.OptimizedLSTMCell(H), name="lstm_bwd"),
            name="bilstm")(x, seq_lengths=lengths)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    params = module_params(_BiLSTM(), 0, jnp.asarray(x),
                           jnp.array([T] * B, jnp.int32))
    packed = [np.asarray(a) for a in pack_bilstm_params(params)]
    return x, params, packed


def _port(packed):
    return [torch.tensor(a) for a in packed]


def test_flip_sequences_matches_tts_tpu():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 9, 3)).astype(np.float32)
    lengths = np.array([9, 5, 1, 7], np.int32)
    want = np.asarray(jflip(jnp.asarray(x), jnp.asarray(lengths)))
    got = flip_sequences(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lengths", list(LENGTH_SETS))
def test_matches_pallas_kernel_everywhere(case, lengths):
    """Every position, pads included: both scan all T steps."""
    x, _, packed = case
    lengths = np.array(LENGTH_SETS[lengths], np.int32)
    want = fused_bilstm(jnp.asarray(x), jnp.asarray(lengths),
                        *map(jnp.asarray, packed), compute_dtype=jnp.float32,
                        interpret=True)
    got = bilstm(torch.from_numpy(x), torch.from_numpy(lengths),
                 *_port(packed))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("lengths", list(LENGTH_SETS))
def test_matches_flax_bidirectional(case, lengths):
    """Inside each item's length, where flax's seq_lengths defines it."""
    x, params, packed = case
    lengths = np.array(LENGTH_SETS[lengths], np.int32)
    want = np.asarray(_BiLSTM().apply({"params": params}, jnp.asarray(x),
                                      jnp.asarray(lengths)))
    got = bilstm_torch(torch.from_numpy(x), torch.from_numpy(lengths),
                       *_port(packed)).numpy()
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATOL)


def test_encoder_packs_like_tts_tpu(case):
    """The encoder's LSTM weights, carried over from a tts_tpu tree, pack
    into tts_tpu's fused (C + H, 4H) operands exactly."""
    _, params, packed = case
    enc = {f"conv_{i}": {"conv": {"kernel": np.zeros((5, C, C), np.float32)},
                         "bn": {"scale": np.ones(C, np.float32),
                                "bias": np.zeros(C, np.float32)}}
           for i in range(3)}
    enc.update(params)
    stats = {"encoder": {f"conv_{i}": {"bn": {"mean": np.zeros(C, np.float32),
                                              "var": np.ones(C, np.float32)}}
                         for i in range(3)},
             "postnet": {}}
    sd = tacotron2_state_dict_from_jax(
        {"embedding": {"embedding": np.zeros((2, C), np.float32)},
         "encoder": enc, "postnet": {}}, stats)
    encoder = Encoder(C)
    encoder.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                             if k.startswith("encoder.")})
    for got, want in zip(encoder.packed_lstm(), packed):
        np.testing.assert_array_equal(got.detach().numpy(), want)


def test_refuses_bf16_operands(case):
    x, _, packed = case
    lengths = torch.tensor([T] * B)
    with pytest.raises(ValueError, match="float32"):
        bilstm(torch.from_numpy(x), lengths, *_port(packed),
               compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        bilstm(torch.from_numpy(x).bfloat16(), lengths, *_port(packed))

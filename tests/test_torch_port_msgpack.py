"""The port reads tts_tpu's flax-msgpack checkpoints without flax or msgpack.

tts_tpu's ``save_checkpoint`` writes the files; every leaf the port reads
must have the shape, dtype and bits of ``flax.serialization.msgpack_restore``
on the same bytes, and ``meta`` must be equal. Covered: float32/int leaves,
numpy scalars (ext 3), complex numbers (ext 2), bfloat16 leaves (read as
torch.bfloat16 tensors of the same bits), flax's chunked arrays (with
``MAX_CHUNK_SIZE`` patched small), and malformed files, which raise with
the byte offset.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tts_tpu.models.glow_tts import GlowTTS as JGlowTTS
from tts_tpu.train.checkpoint import save_checkpoint
from tts_tpu_torch.compat import msgpack as port_msgpack
from tts_tpu_torch.train.checkpoint import (is_torch_checkpoint,
                                            load_tts_tpu_checkpoint)

from tests.torch_port_params import module_params

torch.set_num_threads(1)


def _same_leaves(got, want, path="") -> int:
    """Assert the two trees equal leaf by leaf; returns the leaves seen."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        return sum(_same_leaves(got[k], want[k], f"{path}/{k}") for k in want)
    if isinstance(want, np.ndarray) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            want.view(np.uint16), err_msg=path)
        return 1
    if isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), (path, type(got), type(want))
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
        return 1
    assert type(got) is type(want) and got == want, (path, got, want)
    return 1


@pytest.fixture(scope="module")
def glow_params():
    return module_params(JGlowTTS(num_chars=30, hidden_channels_enc=16,
                                  hidden_channels_dec=16, filter_channels=32,
                                  filter_channels_dp=16, num_layers_enc=1,
                                  num_flow_blocks_dec=2, num_block_layers=2),
                         0, jnp.zeros((1, 8), jnp.int32),
                         jnp.array([8], jnp.int32), jnp.zeros((1, 12, 80)),
                         jnp.array([12], jnp.int32), train=False)


def _restore_both(path):
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    return load_tts_tpu_checkpoint(path), want


def test_reads_a_tts_tpu_checkpoint_bit_for_bit(tmp_path, glow_params):
    stats = {"bn": {"mean": np.arange(6, dtype=np.float32),
                    "var": np.ones((2, 3), np.float64),
                    "count": np.int64(7)}}
    path = save_checkpoint(str(tmp_path), params=glow_params,
                           batch_stats=stats, step=1234, epoch=5, r=2,
                           model_loss=0.125)
    assert not is_torch_checkpoint(path)
    got, want = _restore_both(path)
    assert _same_leaves(got["params"], want["params"]) > 50
    _same_leaves(got["batch_stats"], want["batch_stats"])
    assert got["meta"] == want["meta"]
    assert got["meta"]["step"] == 1234 and got["meta"]["r"] == 2
    assert got["batch_stats"]["bn"]["count"].shape == ()


def test_chunked_and_bfloat16_leaves(tmp_path, glow_params, monkeypatch):
    """Leaves above flax's MAX_CHUNK_SIZE are written as chunk maps (the
    limit patched to 256 bytes here; nothing in tts_tpu changes)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    params = dict(glow_params)
    params["half"] = {"kernel": np.asarray(
        jnp.linspace(-3, 3, 300, dtype=jnp.bfloat16).reshape(20, 15))}
    path = save_checkpoint(str(tmp_path), params=params, step=3)
    with open(path, "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    got, want = _restore_both(path)
    assert _same_leaves(got["params"], want["params"]) > 50
    assert got["params"]["half"]["kernel"].dtype == torch.bfloat16
    assert got["meta"] == want["meta"]


def test_plain_values_scalars_and_complex():
    tree = {"f32": np.float32(1.5), "i8": np.int8(-3), "u64": 2 ** 63 + 5,
            "neg": -(2 ** 40), "f": 0.1, "none": None, "yes": True,
            "no": False, "s": "é" * 40, "blob": b"\x00\x01" * 200,
            "list": [1, [2.5, "x"], {"k": -1}], "c": 1.5 - 2j,
            "big": {str(i): i for i in range(20)},
            "empty": np.zeros((0, 3), np.float32)}
    data = serialization.msgpack_serialize(tree)
    got = port_msgpack.msgpack_restore(data)
    want = serialization.msgpack_restore(data)
    _same_leaves(got, want)


def test_malformed_files_raise(tmp_path, glow_params):
    path = save_checkpoint(str(tmp_path), params=glow_params, step=1)
    with open(path, "rb") as f:
        data = f.read()
    with pytest.raises(ValueError, match="truncated.*at byte"):
        port_msgpack.msgpack_restore(data[:len(data) // 2])
    with pytest.raises(ValueError, match="trailing bytes"):
        port_msgpack.msgpack_restore(data + b"\x00")
    with pytest.raises(ValueError, match="unknown type byte 0xc1 at byte 1"):
        port_msgpack.msgpack_restore(b"\x91\xc1")
    with pytest.raises(ValueError, match="unsupported ext type 9"):
        port_msgpack.msgpack_restore(b"\xd4\x09\x00")
    bad = str(tmp_path / "bad.ckpt")
    with open(bad, "wb") as f:
        f.write(b"\x00not a checkpoint")
    with pytest.raises(ValueError, match="neither"):
        is_torch_checkpoint(bad)
    torch_file = str(tmp_path / "model.pt")
    torch.save({"model": {}}, torch_file)
    assert is_torch_checkpoint(torch_file)

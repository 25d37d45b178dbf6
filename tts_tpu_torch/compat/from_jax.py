"""Carry ``tts_tpu`` (JAX/flax) parameter trees into the port.

The inputs are the flax ``params`` trees as nested dicts of numpy arrays (a
checkpoint's ``params`` after ``np.asarray`` on each leaf); the outputs are
the port's ``state_dict``s. The port's modules use Mozilla TTS's key names,
so ``tts_tpu/compat/torch_port.py`` (Mozilla -> flax) is the inverse of these
functions, and a Mozilla ``.pth.tar`` state dict loads into the port as it
is. Layout changes: flax conv kernels (k, in, out) -> torch (out, in, k);
flax Dense (in, out) -> torch 1x1 conv (out, in, 1); flax ConvTranspose
(2f, in, out) -> torch ConvTranspose1d (in, out, 2f) with time flipped.

Direction: every function here goes from tts_tpu to the port.
``glow_tts_state_dict_from_jax`` only moves and reshapes leaves (no weight
norm is folded), so it also maps any tree of the params' structure leaf by
leaf: the training tests map jax gradients and optax-updated params with it
and compare them with the port's ``.grad`` and parameters by name.
``melgan_state_dict_from_jax`` folds weight norm first, so it maps params
only (and trees without weight norm leaf by leaf);
``melgan_discriminator_state_dict_from_jax`` moves leaves only, and so do
the ParallelWaveGAN converters (flax and torch both norm those convs per
output channel) and ``rwd_state_dict_from_jax``;
``istft_melgan_state_dict_from_jax`` folds as the MelGAN one does;
``tacotron2_state_dict_from_jax`` packs the per-gate LSTM kernels and adds
the zero biases tts_tpu leaves out, so it maps params only, and so do
``tacotron_state_dict_from_jax`` (Tacotron v1's GRUs),
``gst_state_dict_from_jax`` (its GRU; the input features permuted) and
``speaker_encoder_state_dict_from_jax`` (the speaker encoder's LSTMs;
``speaker_loss_state_dict_from_jax`` its loss's ``w`` and ``b``) and
``wavernn_state_dict_from_jax`` (WaveRNN's GRUs). The other
direction, port -> tts_tpu, is ``tts_tpu/compat/torch_port.py`` in the JAX
package. ``state_dict_from_tts_tpu`` picks the converter for a whole
tts_tpu checkpoint (``train/checkpoint.py::load_tts_tpu_checkpoint``) from
its config.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

Tree = Dict[str, Any]


def _flatten(node: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, child in node.items():
        path = f"{prefix}{key}"
        if isinstance(child, dict):
            out.update(_flatten(child, path + "/"))
        else:
            out[path] = np.asarray(child, np.float32)
    return out


def _weight_norm_scales(node: Tree) -> Dict[str, np.ndarray]:
    """{conv name: scale} of the flax ``WeightNorm_*`` entries of ``node``
    (their leaves sit at ``<conv path>/kernel/scale``)."""
    scales = {}
    for key, child in node.items():
        if key.startswith("WeightNorm_") and isinstance(child, dict):
            for path, val in _flatten(child).items():
                parts = path.split("/")
                assert parts[-2:] == ["kernel", "scale"], path
                scales["/".join(parts[:-2])] = val
    return scales


def _conv(kernel: np.ndarray) -> np.ndarray:
    """flax (k, in, out) -> torch Conv1d (out, in, k)."""
    return np.ascontiguousarray(np.transpose(kernel, (2, 1, 0)))


def _conv_transpose(kernel: np.ndarray) -> np.ndarray:
    """flax ConvTranspose (2f, in, out) -> torch ConvTranspose1d
    (in, out, 2f): the inverse of torch_port's time flip."""
    return np.ascontiguousarray(np.transpose(kernel, (1, 2, 0))[:, :, ::-1])


def _norm0(w: np.ndarray) -> np.ndarray:
    """torch weight_norm(dim=0) magnitude: norm over every axis but 0."""
    axes = tuple(range(1, w.ndim))
    return np.sqrt((w.astype(np.float64) ** 2).sum(axis=axes, keepdims=True)
                   ).astype(np.float32)


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Glow-TTS
# ---------------------------------------------------------------------------

def glow_tts_state_dict_from_jax(params: Tree, batch_stats: Tree = None
                                 ) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` GlowTTS params (mean_only, the prenet where the encoder
    type has one: what its registry builds; the transformer, gated-conv or
    time-depth-separable encoder, told by the tree; with speakers,
    ``emb_g`` and every WN's ``cond_layer``) -> the port's ``GlowTTS``
    state dict. Weight-normed convs transfer as they are: flax WeightNorm
    on the (k, in, out) kernel norms over all axes but ``out``, which is
    torch's ``dim=0`` after the transpose. The separable encoder's
    BatchNorm statistics come from ``batch_stats`` (flax's initial 0 and 1
    where it is None: tts_tpu's trainer keeps none)."""
    sd: Dict[str, np.ndarray] = {}

    def conv(dst: str, node: Tree) -> None:
        sd[f"{dst}.weight"] = _conv(np.asarray(node["kernel"]))
        sd[f"{dst}.bias"] = np.asarray(node["bias"])

    def dense(dst: str, node: Tree) -> None:
        sd[f"{dst}.weight"] = np.ascontiguousarray(
            np.asarray(node["kernel"]).T[:, :, None])
        sd[f"{dst}.bias"] = np.asarray(node["bias"])

    def ln(dst: str, node: Tree) -> None:
        sd[f"{dst}.gamma"] = np.asarray(node["scale"])
        sd[f"{dst}.beta"] = np.asarray(node["bias"])

    def wn_conv(dst: str, parent: Tree, name: str) -> None:
        conv(dst, parent[name])
        g = _weight_norm_scales(parent)[name]
        sd[f"{dst}.weight_v"] = sd.pop(f"{dst}.weight")
        sd[f"{dst}.weight_g"] = g.reshape(-1, 1, 1)

    enc = params["encoder"]
    sd["encoder.emb.weight"] = np.asarray(enc["emb"]["embedding"])
    if "prenet" in enc:
        pre = enc["prenet"]
        n_pre = sum(1 for k in pre if k.startswith("conv_"))
        for i in range(n_pre):
            conv(f"encoder.pre.conv_layers.{i}", pre[f"conv_{i}"])
            ln(f"encoder.pre.norm_layers.{i}", pre[f"ln_{i}"])
        conv("encoder.pre.proj", pre["proj"])
    tr = enc["encoder"]
    n_gated = sum(1 for k in tr if k.startswith("conv_"))
    for i in range(n_gated):
        conv(f"encoder.encoder.conv_layers.{i}", tr[f"conv_{i}"])
        ln(f"encoder.encoder.norm_layers.{i}", tr[f"ln_{i}"])
    n_tds = sum(1 for k in tr if k.startswith("layer_"))
    tds_stats = ((batch_stats or {}).get("encoder", {})
                 .get("encoder", {}))
    for i in range(n_tds):
        layer, dst = tr[f"layer_{i}"], f"encoder.encoder.layers.{i}"
        for name in ("time_conv", "depth_conv", "time_conv2"):
            conv(f"{dst}.{name}", layer[name])
        for j in (1, 2, 3):
            bn = layer[f"norm{j}"]
            stats = tds_stats.get(f"layer_{i}", {}).get(f"norm{j}") or {
                "mean": np.zeros_like(bn["bias"]),
                "var": np.ones_like(bn["bias"])}
            _batchnorm(sd, f"{dst}.norm{j}", bn, stats)
    n_layers = sum(1 for k in tr if k.startswith("attn_"))
    for i in range(n_layers):
        a, dst = tr[f"attn_{i}"], f"encoder.encoder.attn_layers.{i}"
        for ours, theirs in (("q", "conv_q"), ("k", "conv_k"),
                             ("v", "conv_v"), ("out", "conv_o")):
            dense(f"{dst}.{theirs}", a[ours])
        if "emb_rel_k" in a:
            sd[f"{dst}.emb_rel_k"] = np.asarray(a["emb_rel_k"])[None]
            sd[f"{dst}.emb_rel_v"] = np.asarray(a["emb_rel_v"])[None]
        ln(f"encoder.encoder.norm_layers_1.{i}", tr[f"ln1_{i}"])
        conv(f"encoder.encoder.ffn_layers.{i}.conv_1", tr[f"ffn_{i}"]["conv1"])
        conv(f"encoder.encoder.ffn_layers.{i}.conv_2", tr[f"ffn_{i}"]["conv2"])
        ln(f"encoder.encoder.norm_layers_2.{i}", tr[f"ln2_{i}"])
    conv("encoder.proj_m", enc["proj_mean"])
    if "emb_g" in params:
        sd["emb_g.weight"] = np.asarray(params["emb_g"]["embedding"])
    dp, dst = enc["duration_predictor"], "encoder.duration_predictor"
    conv(f"{dst}.conv_1", dp["conv1"])
    ln(f"{dst}.norm_1", dp["ln1"])
    conv(f"{dst}.conv_2", dp["conv2"])
    ln(f"{dst}.norm_2", dp["ln2"])
    conv(f"{dst}.proj", dp["proj"])

    dec = params["decoder"]
    n_blocks = sum(1 for k in dec if k.startswith("actnorm_"))
    for i in range(n_blocks):
        base = f"decoder.flows.{3 * i}"
        sd[f"{base}.logs"] = np.asarray(dec[f"actnorm_{i}"]["logs"])[None, :, None]
        sd[f"{base}.bias"] = np.asarray(dec[f"actnorm_{i}"]["bias"])[None, :, None]
        sd[f"decoder.flows.{3 * i + 1}.weight"] = np.asarray(
            dec[f"invconv_{i}"]["weight"])
        cp, cdst = dec[f"coupling_{i}"], f"decoder.flows.{3 * i + 2}"
        wn_conv(f"{cdst}.start", cp, "start")
        conv(f"{cdst}.end", cp["end"])
        wn = cp["wn"]
        n_wn = sum(1 for k in wn if k.startswith("in_"))
        for j in range(n_wn):
            wn_conv(f"{cdst}.wn.in_layers.{j}", wn, f"in_{j}")
            wn_conv(f"{cdst}.wn.res_skip_layers.{j}", wn, f"res_skip_{j}")
        if "cond_layer" in wn:
            wn_conv(f"{cdst}.wn.cond_layer", wn, "cond_layer")
    return _with_batch_counts(_tensors(sd))


def _with_batch_counts(out: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """Add torch's ``num_batches_tracked`` (0) beside every BatchNorm's
    running statistics."""
    for key in list(out):
        if key.endswith(".running_var"):
            out[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.long)
    return out


# ---------------------------------------------------------------------------
# MelGAN family
# ---------------------------------------------------------------------------

def _folded_kernels(node: Tree) -> Tree:
    """Copy of ``node`` with every flax WeightNorm scale folded into its
    kernel (≙ tts_tpu/models/vocoder/fold.py::fold_weight_norm): norm over
    every kernel axis but the last."""
    if not isinstance(node, dict):
        return np.asarray(node, np.float32)
    scales = _weight_norm_scales(node)
    out = {k: _folded_kernels(v) for k, v in node.items()
           if not k.startswith("WeightNorm_")}
    for target, scale in scales.items():
        leaf = out
        for part in target.split("/"):
            leaf = leaf[part]
        kernel = leaf["kernel"]
        axes = tuple(range(kernel.ndim - 1))
        norm = np.sqrt(np.sum(kernel.astype(np.float64) ** 2, axis=axes,
                              keepdims=True))
        leaf["kernel"] = (kernel * (scale / np.maximum(norm, 1e-12))
                          ).astype(np.float32)
    return out


def melgan_state_dict_from_jax(params: Tree, upsample_factors: Sequence[int],
                               num_res_blocks: int
                               ) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` MelGAN-family generator params (weight-normed or already
    folded) -> the port's ``MelganGenerator`` state dict in Mozilla's
    ``layers.N`` layout with ``weight_v``/``weight_g``. Weight norm is folded
    first: flax norms a ConvTranspose kernel per output channel, torch's
    ``dim=0`` per input channel, so the pair cannot transfer verbatim."""
    p = _folded_kernels(params)
    sd: Dict[str, np.ndarray] = {}

    def put(dst: str, weight: np.ndarray, bias: np.ndarray) -> None:
        sd[f"{dst}.weight_v"] = weight
        sd[f"{dst}.weight_g"] = _norm0(weight)
        sd[f"{dst}.bias"] = np.asarray(bias)

    def conv(dst: str, node: Tree) -> None:
        put(dst, _conv(node["kernel"]), node["bias"])

    conv("layers.1", p["proj_in"]["conv"])
    for i in range(len(upsample_factors)):
        up = p[f"upsample_{i}"]
        put(f"layers.{3 + 3 * i}", _conv_transpose(up["kernel"]), up["bias"])
        st, dst = p[f"resstack_{i}"], f"layers.{4 + 3 * i}"
        for j in range(num_res_blocks):
            conv(f"{dst}.blocks.{j}.2", st[f"block_{j}_conv1"]["conv"])
            conv(f"{dst}.blocks.{j}.4", st[f"block_{j}_conv2"]["conv"])
            conv(f"{dst}.shortcuts.{j}", st[f"block_{j}_shortcut"])
    conv(f"layers.{4 + 3 * len(upsample_factors)}", p["proj_out"]["conv"])
    return _tensors(sd)


def melgan_discriminator_state_dict_from_jax(params: Tree
                                             ) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` ``MelganMultiscaleDiscriminator`` params ->
    the port's state dict, layer names kept (``disc_{i}.conv_in``,
    ``down_{i}``, ``conv_post1``, ``conv_out``). Every conv is weight-normed
    per output channel on both sides, so (v, g) transfer verbatim, grouped
    kernels (k, in / groups, out) included. Leaves are only moved and
    reshaped, so gradient trees map the same way."""
    sd: Dict[str, np.ndarray] = {}
    for disc, node in params.items():
        scales = _weight_norm_scales(node)
        for name, conv in node.items():
            if name.startswith("WeightNorm_"):
                continue
            sd[f"{disc}.{name}.weight_v"] = _conv(np.asarray(conv["kernel"]))
            sd[f"{disc}.{name}.weight_g"] = scales[name].reshape(-1, 1, 1)
            sd[f"{disc}.{name}.bias"] = np.asarray(conv["bias"])
    return _tensors(sd)


def istft_melgan_state_dict_from_jax(params: Tree,
                                     upsample_factors: Sequence[int],
                                     num_res_blocks: int
                                     ) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` ``ISTFTMelganGenerator`` params -> the port's state dict.
    Its body is the MelGAN generator's tree with the output conv named
    ``proj_head``, so it goes through ``melgan_state_dict_from_jax``
    (weight norm folded, then re-split per torch's ``dim=0``)."""
    body = {("proj_out" if k == "proj_head" else k): v
            for k, v in params.items()}
    return melgan_state_dict_from_jax(body, upsample_factors, num_res_blocks)


# ---------------------------------------------------------------------------
# ParallelWaveGAN and the random window discriminators
# ---------------------------------------------------------------------------

def _put_conv(sd: Dict[str, np.ndarray], dst: str, parent: Tree, name: str,
              layout=_conv) -> None:
    """``parent[name]``'s kernel (in torch's ``layout``) and bias at
    ``dst``: as ``weight_v`` / ``weight_g`` when a flax WeightNorm of
    ``parent`` holds its scale (per output channel on both sides, so the
    pair moves verbatim), else as ``weight``. Leaves are only moved and
    reshaped, so gradient trees map the same way."""
    leaf = parent[name]
    w = layout(np.asarray(leaf["kernel"], np.float32))
    scales = _weight_norm_scales(parent)
    if name in scales:
        sd[f"{dst}.weight_v"] = w
        sd[f"{dst}.weight_g"] = scales[name].reshape(
            (-1,) + (1,) * (w.ndim - 1))
    else:
        sd[f"{dst}.weight"] = w
    if "bias" in leaf:
        sd[f"{dst}.bias"] = np.asarray(leaf["bias"], np.float32)


def _time_conv2d(kernel: np.ndarray) -> np.ndarray:
    """flax (k_t, 1) conv over (time, mel) with one feature, kernel
    (k_t, 1, 1, 1) -> torch Conv2d (1, 1, 1, k_t) over (B, 1, mel, time)."""
    return np.ascontiguousarray(kernel[:, 0, 0, 0].reshape(1, 1, 1, -1))


def _pwgan_block(sd: Dict[str, np.ndarray], dst: str, blk: Tree) -> None:
    _put_conv(sd, f"{dst}.conv", blk, "conv")
    if "conv_aux" in blk:
        _put_conv(sd, f"{dst}.conv1x1_aux", blk, "conv_aux")
    _put_conv(sd, f"{dst}.conv1x1_skip", blk, "conv_skip")
    _put_conv(sd, f"{dst}.conv1x1_out", blk, "conv_res")


def pwgan_state_dict_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` ``ParallelWaveganGenerator`` params (weight-normed or
    not) -> the port's state dict in Mozilla's names; the inverse of
    ``tts_tpu/compat/torch_port.py::port_pwgan``."""
    sd: Dict[str, np.ndarray] = {}
    up = params["upsample"]
    _put_conv(sd, "upsample_net.conv_in", up, "conv_in")
    n_up = sum(1 for k in up if k.startswith("conv_") and k != "conv_in")
    for i in range(n_up):
        _put_conv(sd, f"upsample_net.upsample.up_layers.{2 * i + 1}", up,
                  f"conv_{i}", _time_conv2d)
    _put_conv(sd, "first_conv", params, "first_conv")
    n_blocks = sum(1 for k in params if k.startswith("block_"))
    for i in range(n_blocks):
        _pwgan_block(sd, f"conv_layers.{i}", params[f"block_{i}"])
    _put_conv(sd, "last_conv_layers.1", params, "post_conv1")
    _put_conv(sd, "last_conv_layers.3", params, "post_conv2")
    return _tensors(sd)


def pwgan_discriminator_state_dict_from_jax(params: Tree
                                            ) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` ``ParallelWaveganDiscriminator`` (``conv_{i}``,
    ``conv_out``) -> the port's ``conv_layers.{2i}``, the output conv
    last."""
    sd: Dict[str, np.ndarray] = {}
    n = sum(1 for k in params if k.startswith("conv_") and k != "conv_out")
    for i in range(n):
        _put_conv(sd, f"conv_layers.{2 * i}", params, f"conv_{i}")
    _put_conv(sd, f"conv_layers.{2 * n}", params, "conv_out")
    return _tensors(sd)


def residual_pwgan_discriminator_state_dict_from_jax(
        params: Tree) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` ``ResidualParallelWaveganDiscriminator`` -> the port's
    (``first_conv.0``, ``conv_layers.{i}``, ``last_conv_layers.{1,3}``)."""
    sd: Dict[str, np.ndarray] = {}
    _put_conv(sd, "first_conv.0", params, "first_conv")
    n_blocks = sum(1 for k in params if k.startswith("block_"))
    for i in range(n_blocks):
        _pwgan_block(sd, f"conv_layers.{i}", params[f"block_{i}"])
    _put_conv(sd, "last_conv_layers.1", params, "post_conv1")
    _put_conv(sd, "last_conv_layers.3", params, "post_conv2")
    return _tensors(sd)


def rwd_state_dict_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` ``RandomWindowDiscriminator`` -> the port's, names kept
    (``uncond_{i}`` / ``cond_{i}`` / block / conv); the Dense ``out``
    becomes a Linear. No weight norm; leaves are only moved."""
    sd: Dict[str, np.ndarray] = {}
    for path, val in _flatten(params).items():
        parts = path.split("/")
        dst = ".".join(parts[:-1])
        if parts[-1] == "bias":
            sd[f"{dst}.bias"] = val
        elif parts[-2] == "out":                     # Dense (in, 1)
            sd[f"{dst}.weight"] = np.ascontiguousarray(val.T)
        else:
            sd[f"{dst}.weight"] = _conv(val)
    return _tensors(sd)


# ---------------------------------------------------------------------------
# Tacotron2
# ---------------------------------------------------------------------------

def _lstm(sd: Dict[str, np.ndarray], dst: str, cell: Tree,
          suffix: str = "") -> None:
    """flax ``OptimizedLSTMCell`` (per-gate kernels ``i{g}`` / ``h{g}``,
    the bias on the h side only, gates i, f, g, o) -> torch's packed
    ``weight_ih`` / ``weight_hh`` (4H, in), the whole bias in ``bias_ih``
    and zeros in ``bias_hh``."""
    w_ih = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"])
                           for g in "ifgo"], axis=1).T
    w_hh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"])
                           for g in "ifgo"], axis=1).T
    b = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in "ifgo"])
    sd[f"{dst}.weight_ih{suffix}"] = w_ih
    sd[f"{dst}.weight_hh{suffix}"] = w_hh
    sd[f"{dst}.bias_ih{suffix}"] = b
    sd[f"{dst}.bias_hh{suffix}"] = np.zeros_like(b)


def _batchnorm(sd: Dict[str, np.ndarray], dst: str, p: Tree,
               s: Tree) -> None:
    sd[f"{dst}.weight"] = np.asarray(p["scale"])
    sd[f"{dst}.bias"] = np.asarray(p["bias"])
    sd[f"{dst}.running_mean"] = np.asarray(s["mean"])
    sd[f"{dst}.running_var"] = np.asarray(s["var"])


def _attention(sd: Dict[str, np.ndarray], dst: str, att: Tree) -> None:
    """A tts_tpu attention's params -> the port's under ``dst``: Graves
    (``N_a_hidden`` / ``N_a_out`` -> ``N_a.0`` / ``N_a.2``) or the
    location-sensitive one (``v``'s bias, which tts_tpu has only with
    ``use_v_bias``, maps to zero where it has none)."""
    if "N_a_hidden" in att:
        for ours, theirs in (("N_a_hidden", "N_a.0"), ("N_a_out", "N_a.2")):
            sd[f"{dst}.{theirs}.weight"] = np.asarray(att[ours]["kernel"]).T
            sd[f"{dst}.{theirs}.bias"] = np.asarray(att[ours]["bias"])
        return
    for name in ("query_layer", "inputs_layer", "v"):
        sd[f"{dst}.{name}.linear_layer.weight"] = \
            np.asarray(att[name]["kernel"]).T
    sd[f"{dst}.v.linear_layer.bias"] = np.asarray(
        att["v"].get("bias", np.zeros((1,), np.float32)))
    if "location_conv" in att:
        loc = f"{dst}.location_layer"
        sd[f"{loc}.location_conv1d.weight"] = _conv(
            np.asarray(att["location_conv"]["kernel"]))
        sd[f"{loc}.location_dense.linear_layer.weight"] = \
            np.asarray(att["location_dense"]["kernel"]).T
    if "transition_agent" in att:
        sd[f"{dst}.ta.weight"] = np.asarray(
            att["transition_agent"]["kernel"]).T
        sd[f"{dst}.ta.bias"] = np.asarray(att["transition_agent"]["bias"])


def _decoder_state_dict(sd: Dict[str, np.ndarray], dst: str, dec: Tree,
                        stats: Tree) -> None:
    for i in range(2):
        layer = f"{dst}.prenet.linear_layers.{i}"
        sd[f"{layer}.linear_layer.weight"] = \
            np.asarray(dec["prenet"][f"linear_{i}"]["kernel"]).T
        if f"bn_{i}" in dec["prenet"]:               # prenet_type "bn"
            _batchnorm(sd, f"{layer}.batch_normalization",
                       dec["prenet"][f"bn_{i}"], stats["prenet"][f"bn_{i}"])
    _lstm(sd, f"{dst}.attention_rnn", dec["attention_rnn"])
    _lstm(sd, f"{dst}.decoder_rnn", dec["decoder_rnn"])
    _attention(sd, f"{dst}.attention", dec["attention"])
    proj = dec["linear_projection"]
    sd[f"{dst}.linear_projection.linear_layer.weight"] = \
        np.asarray(proj["kernel"]).T
    sd[f"{dst}.linear_projection.linear_layer.bias"] = np.asarray(proj["bias"])
    stop = dec["stopnet"]["linear"]
    sd[f"{dst}.stopnet.1.linear_layer.weight"] = np.asarray(stop["kernel"]).T
    sd[f"{dst}.stopnet.1.linear_layer.bias"] = np.asarray(stop["bias"])


def tacotron2_state_dict_from_jax(params: Tree, batch_stats: Tree
                                  ) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` Tacotron2 ``params`` and ``batch_stats`` (location-
    sensitive attention; with the ``speaker_embedding`` and the GST layer
    where the tree has them) -> the port's ``Tacotron2`` state dict,
    Mozilla names. tts_tpu's ConvBN convs have no
    bias (BatchNorm cancels it), so theirs map to zero; the attention's
    ``v`` likewise. The coarse (DDC) and backward decoders map when the
    tree has them. ``port_tacotron2`` in tts_tpu is the inverse."""
    sd: Dict[str, np.ndarray] = {
        "embedding.weight": np.asarray(params["embedding"]["embedding"])}

    def convbn(dst: str, p: Tree, s: Tree) -> None:
        w = _conv(np.asarray(p["conv"]["kernel"]))
        sd[f"{dst}.convolution1d.weight"] = w
        sd[f"{dst}.convolution1d.bias"] = np.zeros((w.shape[0],), np.float32)
        _batchnorm(sd, f"{dst}.batch_normalization", p["bn"], s["bn"])

    enc_p, enc_s = params["encoder"], batch_stats["encoder"]
    for i in range(3):
        convbn(f"encoder.convolutions.{i}", enc_p[f"conv_{i}"],
               enc_s[f"conv_{i}"])
    _lstm(sd, "encoder.lstm", enc_p["OptimizedLSTMCell_0"], "_l0")
    _lstm(sd, "encoder.lstm", enc_p["OptimizedLSTMCell_1"], "_l0_reverse")
    for name in ("decoder", "coarse_decoder", "backward_decoder"):
        if name in params:
            _decoder_state_dict(sd, name, params[name],
                                batch_stats.get(name, {}))
    post_p, post_s = params["postnet"], batch_stats["postnet"]
    for i in range(len(post_p)):
        convbn(f"postnet.convolutions.{i}", post_p[f"conv_{i}"],
               post_s[f"conv_{i}"])
    if "speaker_embedding" in params:
        sd["speaker_embedding.weight"] = np.asarray(
            params["speaker_embedding"]["embedding"])
    if "gst_layer" in params:
        sd.update(_gst_state_dict(params["gst_layer"],
                                  batch_stats["gst_layer"], "gst_layer."))
    return _with_batch_counts(_tensors(sd))


def _conv2d(kernel: np.ndarray) -> np.ndarray:
    """flax Conv (kh, kw, in, out) -> torch Conv2d (out, in, kh, kw)."""
    return np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))


def _gru(sd: Dict[str, np.ndarray], dst: str, cell: Tree,
         feature_order=None, suffix: str = "_l0") -> None:
    """flax ``GRUCell`` (``ir``/``iz``/``in`` with biases, ``hr``/``hz``
    without, ``hn`` with) -> torch's packed ``weight_ih`` / ``weight_hh``
    (3H, in), gates r, z, n; ``bias_hh`` zero on r and z. ``feature_order``
    permutes the input features (torch's column j reads flax's row
    ``feature_order[j]``); ``suffix`` names the torch keys (``_l0`` for
    ``nn.GRU``'s first layer, ``_l0_reverse`` its backward direction, ""
    for ``nn.GRUCell``)."""
    w_ih = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"])
                           for g in "rzn"], axis=1)
    if feature_order is not None:
        w_ih = w_ih[feature_order]
    sd[f"{dst}.weight_ih{suffix}"] = w_ih.T
    sd[f"{dst}.weight_hh{suffix}"] = np.concatenate(
        [np.asarray(cell[f"h{g}"]["kernel"]) for g in "rzn"], axis=1).T
    sd[f"{dst}.bias_ih{suffix}"] = np.concatenate(
        [np.asarray(cell[f"i{g}"]["bias"]) for g in "rzn"])
    b_hn = np.asarray(cell["hn"]["bias"])
    sd[f"{dst}.bias_hh{suffix}"] = np.concatenate(
        [np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn])


def _gst_state_dict(params: Tree, stats: Tree, prefix: str
                    ) -> Dict[str, np.ndarray]:
    """``tts_tpu`` GST params and ``batch_stats`` -> the port's ``GST``
    entries under ``prefix``. The GRU's input features are (mel, channel)
    in flax and (channel, mel) in the port: its input kernel is permuted."""
    sd: Dict[str, np.ndarray] = {}
    ref, ref_s = params["ref_encoder"], stats["ref_encoder"]
    n = sum(1 for k in ref if k.startswith("conv_"))
    for i in range(n):
        sd[f"{prefix}encoder.convs.{i}.weight"] = _conv2d(
            np.asarray(ref[f"conv_{i}"]["kernel"]))
        sd[f"{prefix}encoder.convs.{i}.bias"] = np.asarray(
            ref[f"conv_{i}"]["bias"])
        _batchnorm(sd, f"{prefix}encoder.bns.{i}", ref[f"bn_{i}"],
                   ref_s[f"bn_{i}"])
    C = np.asarray(ref[f"conv_{n - 1}"]["kernel"]).shape[-1]
    M = np.asarray(ref["GRUCell_0"]["ir"]["kernel"]).shape[0] // C
    # torch column c * M + m reads flax row m * C + c
    order = np.arange(M * C).reshape(M, C).T.reshape(-1)
    _gru(sd, f"{prefix}encoder.recurrence", ref["GRUCell_0"], order)
    sd[f"{prefix}style_token_layer.style_tokens"] = np.asarray(
        params["style_tokens"])
    att = params["style_attention"]
    for name in ("W_query", "W_key", "W_value"):
        sd[f"{prefix}style_token_layer.attention.{name}.weight"] = \
            np.asarray(att[name]["kernel"]).T
    return sd


def gst_state_dict_from_jax(params: Tree, batch_stats: Tree
                            ) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` ``GST`` params and ``batch_stats`` -> the port's ``GST``
    state dict."""
    return _with_batch_counts(_tensors(_gst_state_dict(params, batch_stats,
                                                       "")))


# ---------------------------------------------------------------------------
# Tacotron (v1)
# ---------------------------------------------------------------------------

def _cbhg(sd: Dict[str, np.ndarray], dst: str, p: Tree, s: Tree) -> None:
    """A tts_tpu ``CBHG`` (``bank_{k}``, ``proj_{i}``, ``pre_highway``,
    ``highway_{i}``, ``GRUCell_0`` forward / ``GRUCell_1`` backward) -> the
    port's under ``dst``."""
    def bn_conv(name: str, node: Tree, stats: Tree) -> None:
        sd[f"{name}.conv1d.weight"] = _conv(np.asarray(node["conv"]["kernel"]))
        _batchnorm(sd, f"{name}.bn", node["bn"], stats["bn"])

    n_bank = sum(1 for k in p if k.startswith("bank_"))
    for k in range(1, n_bank + 1):
        bn_conv(f"{dst}.conv1d_banks.{k - 1}", p[f"bank_{k}"],
                s[f"bank_{k}"])
    n_proj = sum(1 for k in p if k.startswith("proj_"))
    for i in range(n_proj):
        bn_conv(f"{dst}.conv1d_projections.{i}", p[f"proj_{i}"],
                s[f"proj_{i}"])
    if "pre_highway" in p:
        sd[f"{dst}.pre_highway.weight"] = np.asarray(
            p["pre_highway"]["kernel"]).T
    n_high = sum(1 for k in p if k.startswith("highway_"))
    for i in range(n_high):
        for gate in ("H", "T"):
            node = p[f"highway_{i}"][gate]
            sd[f"{dst}.highways.{i}.{gate}.weight"] = np.asarray(
                node["kernel"]).T
            sd[f"{dst}.highways.{i}.{gate}.bias"] = np.asarray(node["bias"])
    _gru(sd, f"{dst}.gru", p["GRUCell_0"])
    _gru(sd, f"{dst}.gru", p["GRUCell_1"], suffix="_l0_reverse")


def tacotron_state_dict_from_jax(params: Tree, batch_stats: Tree
                                 ) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` Tacotron (v1) ``params`` and ``batch_stats`` (the
    CBHGs' BatchNorms) -> the port's ``Tacotron`` state dict, Mozilla
    names; the location-sensitive or Graves attention, the speaker table
    and the GST layer where the tree has them. ``port_tacotron`` in
    tts_tpu is the inverse."""
    sd: Dict[str, np.ndarray] = {
        "embedding.weight": np.asarray(params["embedding"]["embedding"])}

    def dense(dst: str, node: Tree) -> None:
        sd[f"{dst}.weight"] = np.asarray(node["kernel"]).T
        sd[f"{dst}.bias"] = np.asarray(node["bias"])

    def prenet(dst: str, node: Tree) -> None:
        for i in range(2):
            dense(f"{dst}.linear_layers.{i}.linear_layer", node[f"linear_{i}"])

    enc = params["encoder"]
    prenet("encoder.prenet", enc["prenet"])
    _cbhg(sd, "encoder.cbhg.cbhg", enc["cbhg"],
          batch_stats["encoder"]["cbhg"])
    dec = params["decoder"]
    prenet("decoder.prenet", dec["prenet"])
    _gru(sd, "decoder.attention_rnn", dec["attention_rnn"], suffix="")
    _attention(sd, "decoder.attention", dec["attention"])
    dense("decoder.project_to_decoder_in", dec["project_to_decoder_in"])
    for i in range(2):
        _gru(sd, f"decoder.decoder_rnns.{i}", dec[f"decoder_rnn_{i}"],
             suffix="")
    dense("decoder.proj_to_mel", dec["proj_to_mel"])
    dense("decoder.stopnet.linear", dec["stopnet"]["linear"])
    _cbhg(sd, "postnet.cbhg", params["postnet"]["cbhg"],
          batch_stats["postnet"]["cbhg"])
    dense("last_linear", params["last_linear"])
    if "speaker_embedding" in params:
        sd["speaker_embedding.weight"] = np.asarray(
            params["speaker_embedding"]["embedding"])
    if "gst_layer" in params:
        sd.update(_gst_state_dict(params["gst_layer"],
                                  batch_stats["gst_layer"], "gst_layer."))
    return _with_batch_counts(_tensors(sd))


# ---------------------------------------------------------------------------
# Speaker encoder
# ---------------------------------------------------------------------------

def speaker_encoder_state_dict_from_jax(params: Tree
                                        ) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` ``SpeakerEncoder`` params (``layer_{i}`` with an
    ``OptimizedLSTMCell_0`` and ``proj``) -> the port's state dict in
    Mozilla's names (``layers.{i}.lstm.*_l0``, ``layers.{i}.linear.weight``).
    The whole LSTM bias goes to ``bias_ih_l0``, zeros to ``bias_hh_l0``;
    tts_tpu_torch's encoder holds the latter fixed, so this maps params
    only (a gradient tree maps leaf by leaf but for that zero)."""
    sd: Dict[str, np.ndarray] = {}
    n = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n):
        layer = params[f"layer_{i}"]
        _lstm(sd, f"layers.{i}.lstm", layer["OptimizedLSTMCell_0"], "_l0")
        sd[f"layers.{i}.linear.weight"] = np.asarray(
            layer["proj"]["kernel"]).T
    return _tensors(sd)


def speaker_loss_state_dict_from_jax(params: Tree
                                     ) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` ``GE2ELoss`` / ``AngleProtoLoss`` params -> the port's
    (0-d ``w`` and ``b``)."""
    return {k: torch.tensor(float(np.asarray(params[k])))
            for k in ("w", "b")}


# ---------------------------------------------------------------------------
# WaveRNN
# ---------------------------------------------------------------------------

def wavernn_state_dict_from_jax(params: Tree, batch_stats: Tree
                                ) -> Dict[str, torch.Tensor]:
    """``tts_tpu`` WaveRNN ``params`` and ``batch_stats`` -> the port's
    ``WaveRNN`` state dict in fatchord's names: the MelResNet's convs and
    BatchNorms (``upsample.resnet.*``, with ``num_batches_tracked``), each
    (k, 1, 1) smoothing filter as ``upsample.up_layers.{2i+1}.weight``
    (1, 1, 1, k), ``I``, ``fc1-3`` and the GRUs ``rnn1`` / ``rnn2`` (zeros
    in the r and z thirds of ``bias_hh_l0``, flax's ``hn`` bias in its n
    third). ``port_wavernn`` in tts_tpu is the inverse."""
    up, cell = params["upsample"], params["cell"]
    rp, rs = up["resnet"], batch_stats["upsample"]["resnet"]
    sd: Dict[str, np.ndarray] = {}
    res = "upsample.resnet"
    sd[f"{res}.conv_in.weight"] = _conv(np.asarray(rp["conv_in"]["kernel"]))
    _batchnorm(sd, f"{res}.batch_norm", rp["bn_in"], rs["bn_in"])
    n_blocks = sum(1 for k in rp if k.endswith("_conv1"))
    for i in range(n_blocks):
        dst = f"{res}.layers.{i}"
        for j in (1, 2):
            sd[f"{dst}.conv{j}.weight"] = _conv(
                np.asarray(rp[f"res_{i}_conv{j}"]["kernel"]))
            _batchnorm(sd, f"{dst}.batch_norm{j}", rp[f"res_{i}_bn{j}"],
                       rs[f"res_{i}_bn{j}"])
    sd[f"{res}.conv_out.weight"] = _conv(np.asarray(rp["conv_out"]["kernel"]))
    sd[f"{res}.conv_out.bias"] = np.asarray(rp["conv_out"]["bias"])
    n_up = sum(1 for k in up if k.startswith("smooth_"))
    for i in range(n_up):
        k = np.asarray(up[f"smooth_{i}_kernel"]).reshape(-1)
        sd[f"upsample.up_layers.{2 * i + 1}.weight"] = k.reshape(1, 1, 1, -1)
    for name in ("I", "fc1", "fc2", "fc3"):
        sd[f"{name}.weight"] = np.asarray(cell[name]["kernel"]).T
        sd[f"{name}.bias"] = np.asarray(cell[name]["bias"])
    _gru(sd, "rnn1", cell["rnn1"])
    _gru(sd, "rnn2", cell["rnn2"])
    return _with_batch_counts(_tensors(sd))


def state_dict_from_tts_tpu(ckpt: Tree, c: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """A tts_tpu checkpoint ({"params", "batch_stats", "meta"}) -> the port
    model's state dict, by the config's model: a vocoder config
    (``generator_model``): WaveRNN through ``wavernn_state_dict_from_jax``
    (with the checkpoint's ``batch_stats``), ParallelWaveGAN through
    ``pwgan_state_dict_from_jax``, the iSTFT MelGAN through
    ``istft_melgan_state_dict_from_jax`` and the MelGAN family through
    ``melgan_state_dict_from_jax``, with the upsample factors and residual
    stacks of the config's generator; a TTS config's ``glow_tts`` or
    ``tacotron2`` or ``tacotron`` through their converters (each with the
    checkpoint's ``batch_stats``); a speaker-encoder config (its ``model`` a dict of
    widths) through ``speaker_encoder_state_dict_from_jax`` on the
    checkpoint's ``enc`` tree (the loss's ``w`` and ``b``, under ``loss``,
    through ``speaker_loss_state_dict_from_jax``)."""
    params = ckpt["params"]
    if isinstance(c.get("model"), dict):
        return speaker_encoder_state_dict_from_jax(params["enc"])
    if "generator_model" in c:
        from tts_tpu_torch.models.vocoder.registry import setup_generator
        name = c["generator_model"].lower()
        if name == "wavernn":
            return wavernn_state_dict_from_jax(params, ckpt["batch_stats"])
        if name == "parallel_wavegan_generator":
            return pwgan_state_dict_from_jax(params)
        gen = setup_generator(c, use_weight_norm=False)
        convert = (istft_melgan_state_dict_from_jax
                   if name == "istft_melgan_generator"
                   else melgan_state_dict_from_jax)
        return convert(params, gen.upsample_factors, gen.num_res_blocks)
    name = c.get("model", "").lower()
    if name == "glow_tts":
        return glow_tts_state_dict_from_jax(params, ckpt.get("batch_stats"))
    if name == "tacotron2":
        return tacotron2_state_dict_from_jax(params,
                                             ckpt.get("batch_stats") or {})
    if name == "tacotron":
        return tacotron_state_dict_from_jax(params, ckpt["batch_stats"])
    raise NotImplementedError(f"no tts_tpu checkpoint converter for model "
                              f"{name!r}")

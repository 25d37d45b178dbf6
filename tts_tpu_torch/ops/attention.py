"""Location-sensitive attention as a step function (≙ tts_tpu/ops/attention.py:
``LocationSensitiveAttention``, ``init_attn``), with Mozilla TTS's module
names (``query_layer``, ``inputs_layer``, ``v``, ``location_layer``,
``ta``) so that a Mozilla state dict loads as it is.

The state is a dict of tensors carried by the caller, as in tts_tpu:
``attention_weights`` and ``attention_cum`` (B, T), and with forward
attention ``alpha`` (B, T) and ``u`` (B, 1). Variants: softmax or sigmoid
normalisation, eval-time windowing, forward attention with the optional
transition agent and forward mask. ``GravesAttention`` (≙ tts_tpu's
``GravesAttention``) is the discretized Gaussian mixture, its state
``mu_prev`` (B, K) and ``attention_weights`` (B, T).

``v`` keeps Mozilla's bias. tts_tpu gives it one only with ``use_v_bias``
(Tacotron v1's sigmoid norm, which a shift changes): there it trains;
otherwise it is held fixed and a tts_tpu tree maps to a zero bias (under
softmax a bias is a constant shift and changes nothing).

The location features take the energies' dtype, so bfloat16 parameters
(mixed-precision training) run on the float32 alignment state.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tts_tpu_torch.models.layers import Linear

State = Dict[str, torch.Tensor]


class LocationLayer(nn.Module):
    """Conv (k=31, SAME, no bias) over [previous alignment, cumulative
    alignment], then a dense layer to the attention dim (no bias)."""

    def __init__(self, attn_dim: int, filters: int = 32,
                 kernel_size: int = 31):
        super().__init__()
        self.location_conv1d = nn.Conv1d(2, filters, kernel_size,
                                         padding=(kernel_size - 1) // 2,
                                         bias=False)
        self.location_dense = Linear(filters, attn_dim, bias=False)

    def forward(self, attn_cat: torch.Tensor) -> torch.Tensor:
        """(B, 2, T) -> (B, T, attn_dim)."""
        return self.location_dense(self.location_conv1d(attn_cat)
                                   .transpose(1, 2))


class LocationSensitiveAttention(nn.Module):
    def __init__(self, query_dim: int, embedding_dim: int,
                 attn_dim: int = 128, location_filters: int = 32,
                 location_kernel_size: int = 31, use_location: bool = True,
                 use_forward_attn: bool = False,
                 use_transition_agent: bool = False,
                 forward_attn_mask: bool = False, norm: str = "softmax",
                 windowing: bool = False, win_back: int = 2,
                 win_front: int = 6, use_v_bias: bool = False):
        super().__init__()
        if norm not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown attention norm: {norm}")
        self.query_layer = Linear(query_dim, attn_dim, bias=False)
        self.inputs_layer = Linear(embedding_dim, attn_dim, bias=False)
        self.v = Linear(attn_dim, 1, bias=True)
        self.v.linear_layer.bias.requires_grad_(use_v_bias)
        self.use_location = use_location
        if use_location:
            self.location_layer = LocationLayer(attn_dim, location_filters,
                                                location_kernel_size)
        self.use_transition_agent = use_transition_agent
        if use_transition_agent:
            self.ta = nn.Linear(embedding_dim + query_dim, 1, bias=True)
        self.use_forward_attn = use_forward_attn
        self.forward_attn_mask = forward_attn_mask
        self.norm = norm
        self.windowing = windowing
        self.win_back = win_back
        self.win_front = win_front

    def init_state(self, batch: int, t_in: int, device) -> State:
        """Zero alignments; forward attention's alpha starts as a delta at
        position 0 with a 1e-7 tail, u at 0.5."""
        state = {"attention_weights": torch.zeros(batch, t_in, device=device),
                 "attention_cum": torch.zeros(batch, t_in, device=device)}
        if self.use_forward_attn:
            alpha = torch.full((batch, t_in), 1e-7, device=device)
            alpha[:, 0] = 1.0
            state["alpha"] = alpha
            state["u"] = torch.full((batch, 1), 0.5, device=device)
        return state

    def preprocess_inputs(self, inputs: torch.Tensor) -> torch.Tensor:
        return self.inputs_layer(inputs)

    def energies(self, query: torch.Tensor, processed_inputs: torch.Tensor,
                 state: State) -> torch.Tensor:
        """(B, D_q), (B, T, A) -> (B, T) unnormalised energies."""
        x = self.query_layer(query)[:, None, :] + processed_inputs
        if self.use_location:
            attn_cat = torch.stack([state["attention_weights"],
                                    state["attention_cum"]], dim=1
                                   ).to(x.dtype)
            x = x + self.location_layer(attn_cat)
        return self.v(torch.tanh(x))[..., 0]

    def _apply_windowing(self, energies: torch.Tensor, state: State
                         ) -> torch.Tensor:
        """-inf outside [argmax - win_back, argmax + win_front] of the
        previous alignment."""
        center = torch.argmax(state["attention_weights"], dim=-1,
                              keepdim=True)
        pos = torch.arange(energies.shape[-1], device=energies.device)[None]
        keep = (pos >= center - self.win_back) & (pos <= center
                                                  + self.win_front)
        return energies.masked_fill(~keep, float("-inf"))

    def _forward_attention(self, alignment: torch.Tensor, state: State
                           ) -> torch.Tensor:
        alpha = state["alpha"]
        u = state["u"] if self.use_transition_agent else 0.5
        shifted = F.pad(alpha, (1, 0))[:, :-1]
        alpha_new = ((1.0 - u) * alpha + u * shifted + 1e-8) * alignment
        if self.forward_attn_mask:
            fwd_shifted = F.pad(alpha, (0, 1))[:, 1:]
            peak = torch.argmax(torch.maximum(fwd_shifted, alpha), dim=-1,
                                keepdim=True)
            pos = torch.arange(alpha.shape[-1], device=alpha.device)[None]
            keep = (pos <= peak + 1).to(alpha.dtype)
            alpha_new = alpha_new * keep + 1e-7 * (1.0 - keep)
        return alpha_new / (alpha_new.sum(dim=-1, keepdim=True) + 1e-8)

    def forward(self, query: torch.Tensor, inputs: torch.Tensor,
                processed_inputs: torch.Tensor, state: State,
                mask: Optional[torch.Tensor] = None,
                use_windowing: bool = False
                ) -> Tuple[torch.Tensor, State]:
        """One step: (context (B, D), new state)."""
        energies = self.energies(query, processed_inputs, state)
        if use_windowing and self.windowing:
            energies = self._apply_windowing(energies, state)
        if mask is not None:
            energies = energies.masked_fill(~mask, -1e9)
        energies = energies.float()
        if self.norm == "softmax":
            alignment = torch.softmax(energies, dim=-1)
        else:
            sig = torch.sigmoid(energies)
            alignment = sig / (sig.sum(dim=-1, keepdim=True) + 1e-8)
        new_state = dict(state)
        # the location statistics take the alignment before forward
        # attention
        new_state["attention_cum"] = state["attention_cum"] + alignment
        if self.use_forward_attn:
            alignment = self._forward_attention(alignment, state)
            new_state["alpha"] = alignment
        new_state["attention_weights"] = alignment
        context = torch.einsum("bt,btd->bd", alignment.to(inputs.dtype),
                               inputs)
        if self.use_transition_agent:
            new_state["u"] = torch.sigmoid(
                self.ta(torch.cat([context, query], dim=-1)))
        return context, new_state


class GravesAttention(nn.Module):
    """Discretized GMM attention (GMMv2b, ≙ tts_tpu's ``GravesAttention``)
    under Mozilla's names: ``N_a.0`` (query_dim -> query_dim, ReLU) and
    ``N_a.2`` (-> 3K: mixture logits g, scales b, mean steps k). The means
    only grow: mu_t = mu_{t-1} + softplus(k). The mass at position j is
    F(j + 1) - F(j) of the mixture's CDF F(x) = sum_k g_k sigmoid((x -
    mu_k) / sigma_k), floored at 1e-8 and then masked; it is not
    renormalised."""

    def __init__(self, query_dim: int, K: int = 5):
        super().__init__()
        self.K = K
        self.N_a = nn.Sequential(nn.Linear(query_dim, query_dim), nn.ReLU(),
                                 nn.Linear(query_dim, 3 * K))

    def init_state(self, batch: int, t_in: int, device) -> State:
        return {"mu_prev": torch.zeros(batch, self.K, device=device),
                "attention_weights": torch.zeros(batch, t_in,
                                                 device=device)}

    def preprocess_inputs(self, inputs: torch.Tensor) -> None:
        return None

    def forward(self, query: torch.Tensor, inputs: torch.Tensor,
                processed_inputs: None, state: State,
                mask: Optional[torch.Tensor] = None,
                use_windowing: bool = False
                ) -> Tuple[torch.Tensor, State]:
        """One step: (context (B, D), new state); ``processed_inputs`` and
        ``use_windowing`` are not read."""
        g, b, k = torch.chunk(self.N_a(query), 3, dim=-1)
        g = torch.softmax(g, dim=-1) + 1e-7
        sigma = F.softplus(b) + 1e-7
        mu = state["mu_prev"] + F.softplus(k)
        j = torch.arange(inputs.shape[1] + 1, dtype=torch.float32,
                         device=query.device)
        cdf = (g[..., None] * torch.sigmoid(
            (j - mu[..., None]) / sigma[..., None])).sum(dim=1)
        alpha = torch.clamp(cdf[:, 1:] - cdf[:, :-1], min=1e-8)
        if mask is not None:
            alpha = alpha.masked_fill(~mask, 0.0)
        context = torch.einsum("bt,btd->bd", alpha.to(inputs.dtype), inputs)
        return context, {"mu_prev": mu, "attention_weights": alpha}


def init_attn(attn_type: str, *, query_dim: int, embedding_dim: int,
              attn_dim: int = 128, attn_K: int = 5,
              location_attention: bool = True,
              use_forward_attn: bool = False,
              use_transition_agent: bool = False,
              forward_attn_mask: bool = False, norm: str = "softmax",
              windowing: bool = False, use_v_bias: bool = False
              ) -> nn.Module:
    """Attention factory (≙ init_attn): "graves" (``attn_K`` mixture
    components) or "original" (location-sensitive)."""
    if attn_type == "graves":
        return GravesAttention(query_dim, attn_K)
    if attn_type != "original":
        raise ValueError(f"unknown attention type: {attn_type}")
    return LocationSensitiveAttention(
        query_dim, embedding_dim, attn_dim=attn_dim,
        use_location=location_attention, use_forward_attn=use_forward_attn,
        use_transition_agent=use_transition_agent,
        forward_attn_mask=forward_attn_mask, norm=norm, windowing=windowing,
        use_v_bias=use_v_bias)

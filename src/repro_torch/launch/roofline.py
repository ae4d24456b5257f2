"""Roofline terms of a dry run, and analytic model FLOPs from a config.

Three terms per (arch × shape × mesh), all in seconds-per-step-per-device:

  compute    = FLOPs(per device)          / peak FLOP/s
  memory     = bytes accessed(per device) / HBM bandwidth
  collective = sum over mesh axes of that axis's wire bytes / its link

against the H100 constants of ``launch/mesh.HW``: the model axis on
NVLink inside a node, the data and pod axes on InfiniBand between nodes.
The per-device FLOPs and bytes come from the dry run's counter
(``launch/costs``); the collectives from the ops it recorded, each
priced with the reference's ring-cost models at its group's size n:

  all-reduce       2 * size * (n-1)/n     (result size = full tensor)
  all-gather       size * (n-1)/n         (result = gathered tensor)
  reduce-scatter   size * (n-1)            (result = shard; input n*size)
  all-to-all       size * (n-1)/n
  collective-permute  size

:func:`model_flops` is ``6·N_active·tokens`` for training and
``2·N_active·tokens`` for a forward pass; the stage-2 judge prices its
prefill with it (``core/judge_pipeline.judge_token_cost``).
"""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict

from repro_torch.launch.mesh import AXIS_LINK, HW
from repro_torch.nn.config import LayerSpec, ModelConfig

# the dry run's collective ops under the reference's HLO names
_OP_NAMES = {"all_reduce": "all-reduce",
             "all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all",
             "broadcast": "collective-permute"}


def wire_bytes(op: str, size: float, n: int) -> float:
    """Bytes one device puts on the wire for one collective (the
    reference's per-op ring-cost models; ``op`` an HLO name)."""
    n = max(n, 1)
    if op == "all-reduce":
        return 2 * size * (n - 1) / n
    if op == "all-gather":
        return size * (n - 1) / n
    if op == "reduce-scatter":
        return size * (n - 1)
    if op == "all-to-all":
        return size * (n - 1) / n
    return size  # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    by_op: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)
    # wire bytes per mesh axis (the port's addition: each axis has its link)
    wire_by_axis: dict = dataclasses.field(default_factory=dict)


def collective_stats(records, groups: dict) -> CollectiveStats:
    """Stats of the collectives a dry run recorded: ``records`` ``(op,
    result bytes, group name)`` (``launch/costs.CostMode.collectives``),
    ``groups`` ``{group name: (mesh axis, group size)}``."""
    stats = CollectiveStats(by_op=defaultdict(float), counts=Counter(),
                            wire_by_axis=defaultdict(float))
    for op, size, group in records:
        base = _OP_NAMES.get(op, op)
        axis, n = groups[group]
        wire = wire_bytes(base, size, n)
        stats.wire_bytes += wire
        stats.by_op[base] += wire
        stats.counts[base] += 1
        stats.wire_by_axis[axis] += wire
    stats.by_op = dict(stats.by_op)
    stats.counts = dict(stats.counts)
    stats.wire_by_axis = dict(stats.wire_by_axis)
    return stats


def _link(axes: str) -> str:
    """The link of a mesh axis, or of axes joined with "+" (a collective
    over several at once goes at the slowest one's rate)."""
    links = [AXIS_LINK.get(a, "ib_bw") for a in axes.split("+")]
    return "ib_bw" if "ib_bw" in links else "nvlink_bw"


@dataclasses.dataclass
class Roofline:
    flops: float           # per device
    bytes_accessed: float  # per device
    wire_bytes: float      # per device
    n_devices: int
    model_flops: float     # global useful flops (6·N_active·tokens etc.)
    wire_by_axis: dict = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / HW["peak_flops_bf16"]

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HW["hbm_bw"]

    @property
    def t_collective(self) -> float:
        """Each axis's wire bytes over its own link (NVLink for "model",
        InfiniBand for "data" and "pod"); an axis-less total (no
        ``wire_by_axis``) over NVLink."""
        if not self.wire_by_axis:
            return self.wire_bytes / HW["nvlink_bw"]
        return sum(w / HW[_link(a)] for a, w in self.wire_by_axis.items())

    @property
    def bottleneck(self) -> str:
        ts = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(ts, key=ts.get)

    @property
    def step_time(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-flops utilisation at the roofline step time."""
        denom = self.step_time * HW["peak_flops_bf16"] * self.n_devices
        return self.model_flops / denom if denom else 0.0


# ------------------------------------------------------- model flops


def _layer_params(l: LayerSpec, d: int, paper_heads: int | None = None) -> tuple[int, int]:
    """(active_params, total_params) of one layer (channel+seq mixers)."""
    act = tot = 0
    if l.kind == "attn":
        a = l.attn
        if a.kind == "mla":
            p = d * (a.kv_lora_rank + a.qk_rope_dim)
            if a.q_lora_rank:
                p += d * a.q_lora_rank + a.q_lora_rank * a.n_heads * (
                    a.qk_nope_dim + a.qk_rope_dim
                )
            else:
                p += d * a.n_heads * (a.qk_nope_dim + a.qk_rope_dim)
            p += a.n_heads * a.qk_nope_dim * a.kv_lora_rank
            p += a.n_heads * a.kv_lora_rank * a.v_head_dim
            p += a.n_heads * a.v_head_dim * d
        else:
            h = paper_heads or a.n_heads
            p = d * h * a.head_dim * 2 + d * a.n_kv_heads * a.head_dim * 2
        act += p
        tot += p
        if l.cross_attn:
            ca = d * a.n_heads * a.head_dim * 2 + d * a.n_kv_heads * a.head_dim * 2
            act += ca
            tot += ca
    elif l.kind == "mamba":
        m = l.mamba
        di = m.expand * d
        dtr = m.dt_rank or -(-d // 16)
        p = d * 2 * di + m.d_conv * di + di * (dtr + 2 * m.d_state) + \
            dtr * di + di * d
        act += p
        tot += p
    elif l.kind == "mlstm":
        xc = l.xlstm
        di = int(xc.proj_factor * d)
        p = d * 2 * di + 3 * di * di + di * d
        act += p
        tot += p
    elif l.kind == "slstm":
        xc = l.xlstm
        dh = d // xc.n_heads
        p = d * 4 * d + xc.n_heads * dh * 4 * dh + d * d
        act += p
        tot += p
    if l.moe is not None:
        mo = l.moe
        routed_one = 3 * d * mo.d_ff_expert
        act += mo.top_k * routed_one
        tot += mo.n_experts * routed_one
        act += d * mo.n_experts  # router
        tot += d * mo.n_experts
        if mo.n_shared:
            sh = 3 * d * (mo.d_ff_shared or mo.d_ff_expert * mo.n_shared)
            act += sh
            tot += sh
    elif l.d_ff:
        n_mats = 3 if l.ffn_act == "swiglu" else 2
        act += n_mats * d * l.d_ff
        tot += n_mats * d * l.d_ff
    return act, tot


def active_params(cfg: ModelConfig, paper_heads: int | None = None) -> tuple[int, int]:
    """(active, total) parameter counts — analytic, from the config."""
    act = tot = 0
    for l in cfg.layer_iter():
        a, t = _layer_params(l, cfg.d_model, paper_heads)
        act += a
        tot += t
    if cfg.enc_dec:
        for _ in range(cfg.enc_repeat):
            for l in cfg.enc_blocks:
                a, t = _layer_params(l, cfg.d_model, paper_heads)
                act += a
                tot += t
    # unembedding projection participates in compute
    act += cfg.d_model * cfg.vocab_size
    tot += cfg.d_model * cfg.vocab_size
    if not cfg.tie_embeddings:
        tot += cfg.d_model * cfg.vocab_size  # input table (gather only)
    return act, tot


def model_flops(cfg: ModelConfig, kind: str, tokens: int,
                paper_heads: int | None = None) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens
    (prefill/decode forward). Attention score/value FLOPs are intentionally
    excluded (the brief's 6·N·D definition); the useful-flops ratio then
    also exposes quadratic-attention overhead at long context."""
    act, _ = active_params(cfg, paper_heads)
    mult = 6.0 if kind == "train" else 2.0
    return mult * act * tokens

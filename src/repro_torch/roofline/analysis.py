"""Roofline bounds of the port's programs from a shape trace (mirrors
``repro/roofline/analysis.py``; no card needed).

Three terms per (arch x shape x mesh), all in seconds, per device:

    compute    = operations / peak operations of their dtype
    memory     = bytes moved / HBM bandwidth
    collective = each collective's output bytes / the link its group spans

Where the reference reads XLA's ``cost_analysis()`` and parses HLO text,
the port observes what its own programs do (``roofline/hlo_profile.py``):
one ``OpRecord`` per aten op, per hand-written kernel call and per
collective that ``core/primitives.py`` issues, traced eagerly on ``meta``
tensors (every layer is counted, so no depth extrapolation).  Operations
are ``torch.utils.flop_counter``'s count of each aten op plus
``kernels.cost.kernel_cost`` of each kernel call; bytes are each aten op's input
and output bytes (eager ops do not fuse, so that is the traffic to
device memory; views move nothing) plus the kernels' bytes.  Every number
is a bound computed from shapes over the data sheet below, never a
measurement.

Hardware constants: NVIDIA H100 (SXM unless named), from NVIDIA's H100
data sheet: dense peaks, no sparsity.  A collective whose group stays
inside one node of 8 GPUs runs over NVLink 4; one that crosses nodes over
one 400 Gb/s NIC a GPU (the DGX H100 layout).  Ranks r and s share a node
when ``r // 8 == s // 8``, so a 16-wide axis of consecutive ranks, or any
strided one, crosses nodes.
"""

from __future__ import annotations

from dataclasses import dataclass

# (HBM bytes/s, bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor
# cores, TF32 tensor-core FLOP/s), dense, from NVIDIA's H100 data sheet for
# each form factor (TF32 is half the bf16 rate).
PEAKS = {"H100 SXM": (3.35e12, 989e12, 67e12, 494.5e12),
         "H100 PCIe": (2.0e12, 756e12, 51e12, 378e12),
         "H100 NVL": (3.9e12, 835e12, 60e12, 417.5e12)}
HBM_BW, PEAK_FLOPS, _, _ = PEAKS["H100 SXM"]
HBM_BYTES = 80e9        # H100 SXM: 80 GB of HBM3 (data sheet)
NVLINK_BW = 450e9       # NVLink 4: 900 GB/s a GPU, 450 each direction
NIC_BW = 50e9           # one 400 Gb/s NIC a GPU (DGX H100 data sheet)
NODE = 8                # GPUs joined by NVLink in one node

SOURCE = ("dry run: counts from shapes over the H100 SXM data sheet; "
          "not measured")

# dtypes the tensor cores take at the bf16 rate; every other float runs
# at the fp32 rate (TF32 is off for the port's aten matmuls, as in
# chip_smoke.py), except a kernel route's work on the TF32 tensor cores
# (ROUTE_PASSES)
_TENSOR_CORE = {"bfloat16", "float16"}
# the fp32 kernels' route on the TF32 tensor cores: each operation of the
# work is three TF32 products (hi*hi, hi*lo, lo*hi; ``kernels/csrc``)
ROUTE_PASSES = {"tf32x3": 3}


def peaks(name: str):
    """(table name, (bytes/s, bf16 FLOP/s, fp32 FLOP/s, TF32 FLOP/s)) of
    the card whose
    ``torch.cuda.get_device_name`` is ``name``: PCIe and NVL by name,
    otherwise SXM."""
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def peak_flops(dtype, table=PEAKS["H100 SXM"], route: str = "") -> float:
    """The peak operations/s of ``dtype``'s work: the tensor-core bf16
    rate for 16-bit floats, the fp32 rate otherwise; a kernel of a route
    in ``ROUTE_PASSES`` at the TF32 rate over its passes."""
    if route in ROUTE_PASSES:
        return table[3] / ROUTE_PASSES[route]
    return table[1] if _dtype_name(dtype) in _TENSOR_CORE else table[2]


def link_bw(ranks) -> float:
    """The per-direction bytes/s of the link a group of global ``ranks``
    spans: NVLink inside one node of ``NODE``, the NIC across nodes."""
    nodes = {int(r) // NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NIC_BW


def bound(cost: dict, dtype, table=PEAKS["H100 SXM"],
          route: str = "") -> dict:
    """The least time of ``cost`` (``kernels.cost.kernel_cost``'s dict) on
    a card of ``table``'s peaks: the larger of its bytes over the memory
    rate and its operations over ``dtype``'s peak (``route``'s, for a
    kernel of a route in ``ROUTE_PASSES``), in ms, and which of the two
    binds."""
    bytes_ms = cost["bytes"] / table[0] * 1e3
    flops_ms = cost["flops"] / peak_flops(dtype, table, route) * 1e3
    return {"bytes_ms": bytes_ms, "flops_ms": flops_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def collective_bytes(records) -> dict:
    """Per-collective-kind output bytes (per device) and counts of the
    collective records of a trace (``hlo_profile.OpRecord``)."""
    out: dict[str, int] = {}
    counts: dict[str, int] = {}
    for rec in records:
        if rec.kind != "collective":
            continue
        out[rec.op] = out.get(rec.op, 0) + rec.out_bytes
        counts[rec.op] = counts.get(rec.op, 0) + 1
    return {"bytes": out, "counts": counts,
            "total_bytes": sum(out.values())}


@dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    model_flops: float
    chips: int
    # each op priced at its dtype's peak, each collective at the link its
    # group spans (``analyze``)
    t_compute: float
    t_collective: float

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / traced operations (per chip): recompute, causal
        masking and dispatch waste show up here."""
        per_chip_model = self.model_flops / self.chips
        return per_chip_model / self.flops if self.flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on model-flops utilization implied by the dominant
        term: (model flops per chip / peak) / t_bound."""
        per_chip_model = self.model_flops / self.chips
        return (per_chip_model / PEAK_FLOPS) / self.t_bound if self.t_bound else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "coll_bytes_per_chip": self.coll_bytes,
            "model_flops_global": self.model_flops,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops(cfg, shape_name: str) -> float:
    """Analytic MODEL_FLOPS per step: 6·N_active·tokens for training
    (2·N_a·tokens forward-only) + exact attention terms."""
    from repro_torch.configs import SHAPES
    cell = SHAPES[shape_name]
    B, S = cell.global_batch, cell.seq_len
    n_active = cfg.active_param_count()
    hd = cfg.resolved_head_dim
    n_attn = sum(1 for i in range(cfg.num_layers) if cfg.mixer_kind(i) == "attn")

    if cell.kind == "train":
        tokens = B * S
        matmul = 6 * n_active * tokens
        attn = 3 * 2 * B * cfg.num_heads * S * S * hd * n_attn / 2  # causal half
        return matmul + attn
    if cell.kind == "prefill":
        tokens = B * S
        return 2 * n_active * tokens + 2 * B * cfg.num_heads * S * S * hd * n_attn / 2
    # decode: one token per sequence; attention reads the whole cache
    return 2 * n_active * B + 4 * B * cfg.num_heads * S * hd * n_attn


def ssd_flops_fwd(cfg, B: int, S: int, L: int = 64) -> float:
    """Analytic forward flops of the chunked SSD scan (dominant matmul
    terms)."""
    if not cfg.ssm_state:
        return 0.0
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    n_ssm = sum(1 for i in range(cfg.num_layers) if cfg.mixer_kind(i) == "ssm")
    per_tok = 2 * H * P * (L + 2 * N) + 2 * L * N
    return float(B) * S * per_tok * n_ssm


def analyze(trace, cfg, shape_name: str, chips: int) -> Roofline:
    """The roofline of one traced step (``hlo_profile.Trace`` or its
    records): operations and bytes of every aten op and kernel call, each
    op priced at its dtype's peak (a kernel call at its route's), and each
    collective's output bytes over the link its group spans."""
    records = getattr(trace, "records", trace)
    flops = byts = coll = 0
    compute_s = collective_s = 0.0
    for rec in records:
        if rec.kind == "collective":
            coll += rec.out_bytes
            collective_s += rec.out_bytes / link_bw(rec.ranks)
            continue
        flops += rec.flops
        byts += rec.in_bytes + rec.out_bytes
        if rec.flops:
            compute_s += rec.flops / peak_flops(rec.dtype, route=rec.route)
    return Roofline(flops=float(flops), bytes_accessed=float(byts),
                    coll_bytes=float(coll),
                    model_flops=model_flops(cfg, shape_name), chips=chips,
                    t_compute=compute_s, t_collective=collective_s)

"""Sharding policy: logical tensor axes -> mesh PartitionSpecs (mirrors
``repro/sharding/policy.py``).

The mesh is a ``DeviceMesh`` (``launch/mesh.py``) whose
``mesh_dim_names`` are the JAX package's axis names.  Logical axes:

  batch   -> (pod, data)          data parallelism (pod = cross-pod DP)
  data    -> data_axis            the bare DP replica axis (no pod)
  seq     -> ctx_axis | model     sequence sharding for residuals: the ctx
                                   axis when context parallelism is live,
                                   else the SP seq->model overload
  ctx     -> ctx_axis             context parallelism (sequence ring); None
                                   when the mesh has no live ctx axis
  heads   -> model                tensor parallelism (paper §4 affine P_fo)
  ff      -> model                TP on the FFN hidden dim
  experts -> ep_axis | model      expert parallelism: the ep axis when live,
                                   else the EP-over-model overload
  ep      -> ep_axis              the expert dispatch axis itself
  vocab   -> model                TP on the embedding / lm head
  fsdp    -> data (+pod)          ZeRO-3 parameter sharding
  kvdim   -> model                decode KV-cache head_dim sharding
  pipe    -> pipe_axis            pipeline stages

The reference's GSPMD methods (``sharding``, ``constrain``,
``param_shardings``) have no counterpart: torch has no compiler that
places a value by annotation.  Where the reference constrains a value's
layout, the port runs the code as an explicit region (``core/compile.py::
dist_jit``): the boundary specs place every input and output, and the body
moves data only through the paper's primitives.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..core.linop import PartitionSpec as P


@dataclass(frozen=True)
class Policy:
    mesh: object                         # a DeviceMesh (or any object with
                                         # mesh_dim_names and size(dim))
    data_axis: str | None = "data"       # None: no DP axis (batch replicated)
    model_axis: str | None = "model"     # None: no TP axis
    pod_axis: str | None = None          # set on the multi-pod mesh
    pipe_axis: str | None = None         # pipeline-parallel stage axis
    ctx_axis: str | None = None          # context-parallel sequence ring
                                         # (see active_ctx_axis)
    ep_axis: str | None = None           # expert-parallel dispatch axis
                                         # (see active_ep_axis)
    fsdp: bool = True                    # ZeRO-3 param sharding over data
    fsdp_over_pod: bool = False          # also shard params over pod axis
    seq_shard: bool = True               # SP: residuals sharded over model
    explicit_tp: bool = False            # TP matmuls as ring collective-
                                         # matmuls (core/overlap.py)
    explicit_moe: bool = True            # MoE via all_to_all (EP)
    kv_layout: str = "kvdim"             # decode cache: "kvdim" | "kvseq"
    aliases: tuple = ()                  # extra logical-axis bindings,
                                         # ((name, target), ...): see bind()

    @property
    def axis_names(self) -> tuple:
        return tuple(self.mesh.mesh_dim_names)

    @classmethod
    def for_mesh(cls, mesh, **kw) -> "Policy":
        """A minimal policy over an arbitrary mesh (tests, layer shims):
        logical names resolve only through mesh axis names and explicit
        ``bind`` aliases."""
        names = tuple(mesh.mesh_dim_names)
        if "ep" in names:
            # The ep axis carries ONLY expert dispatch: never alias data or
            # model onto it; the other axes assign as below.
            kw.setdefault("ep_axis", "ep")
        core = tuple(n for n in names if n != "ep")
        if "ctx" in core:
            # The ctx axis carries ONLY the sequence ring.
            kw.setdefault("ctx_axis", "ctx")
            rest = tuple(n for n in core if n not in ("pipe", "ctx"))
            kw.setdefault("pipe_axis", "pipe" if "pipe" in core else None)
            kw.setdefault("model_axis", rest[-1] if rest else None)
            kw.setdefault("data_axis", rest[0] if len(rest) > 1 else None)
        elif "pipe" in core:
            # Never alias data or model onto the pipe axis; with a single
            # non-pipe axis there is NO data axis.
            non_pipe = tuple(n for n in core if n != "pipe")
            kw.setdefault("pipe_axis", "pipe")
            kw.setdefault("model_axis", non_pipe[-1] if non_pipe else None)
            kw.setdefault("data_axis",
                          non_pipe[0] if len(non_pipe) > 1 else None)
        else:
            kw.setdefault("pipe_axis", None)
            kw.setdefault("data_axis", core[0] if core else None)
            kw.setdefault("model_axis", core[-1] if core else None)
        kw.setdefault("fsdp", False)
        kw.setdefault("seq_shard", False)
        return cls(mesh, **kw)

    def bind(self, **aliases) -> "Policy":
        """Derived policy with extra logical-axis aliases:
        ``policy.bind(fi="model", fo="data")`` makes ``Partitioned("fi")``
        resolve through the alias.  Values may be mesh axis names, other
        logical names, or None (force replication)."""
        merged = dict(self.aliases)
        merged.update(aliases)
        return dataclasses.replace(self, aliases=tuple(sorted(merged.items())))

    # ---- logical -> physical ---------------------------------------------
    def resolve_axis(self, name):
        """Resolve one ``Partitioned`` entry to mesh axes (or None): mesh
        axis names pass through verbatim, tuples resolve element-wise, the
        rest goes through the alias table and ``phys``."""
        if name is None or name == "none":
            return None
        if isinstance(name, (tuple, list)):
            out = []
            for a in name:
                r = self.resolve_axis(a)
                if r is None:
                    continue
                out.extend(r) if isinstance(r, tuple) else out.append(r)
            return tuple(out) if out else None
        if name in self.axis_names:
            return name
        for alias, target in self.aliases:
            if name == alias:
                return self.resolve_axis(target)
        return self.phys(name)

    def phys(self, logical: str | None):
        if logical is None or logical == "none":
            return None
        if logical == "batch":
            data = self.active_data_axis
            if self.pod_axis:
                return (self.pod_axis, data) if data else self.pod_axis
            return data
        if logical == "data":
            return self.active_data_axis
        if logical == "seq":
            # a live ctx axis takes precedence over the SP seq->model overload
            ctx = self.active_ctx_axis
            if ctx:
                return ctx
            return self.model_axis if self.seq_shard else None
        if logical == "ctx":
            return self.active_ctx_axis
        if logical == "experts":
            return self.active_ep_axis or self.model_axis
        if logical == "ep":
            return self.active_ep_axis
        if logical in ("heads", "ff", "vocab", "kvdim", "kvseq", "model"):
            return self.model_axis
        if logical in ("pipe", "stage"):
            return self.pipe_axis
        if logical == "fsdp":
            if not self.fsdp:
                return None
            data = self.active_data_axis
            if self.fsdp_over_pod and self.pod_axis:
                return (self.pod_axis, data) if data else self.pod_axis
            return data
        raise ValueError(f"unknown logical axis {logical!r}")

    def spec(self, *logical) -> P:
        return P(*(self.phys(l) for l in logical))

    # ---- axis sizes ------------------------------------------------------
    def axis_size(self, name: str) -> int:
        """Size of mesh axis ``name`` (``KeyError`` for an absent axis, as
        the reference's lookup)."""
        return {n: int(self.mesh.size(i))
                for i, n in enumerate(self.axis_names)}[name]

    @property
    def active_data_axis(self) -> str | None:
        """``data_axis`` if it names a mesh axis, else None: the one
        predicate for "does this policy really have a DP axis"."""
        if self.data_axis and self.data_axis in self.axis_names:
            return self.data_axis
        return None

    @property
    def active_ctx_axis(self) -> str | None:
        """``ctx_axis`` if it names a mesh axis of size > 1, else None: a
        size-1 ring deactivates, so ctx=1 is exactly the path without it."""
        if (self.ctx_axis and self.ctx_axis in self.axis_names
                and self.axis_size(self.ctx_axis) > 1):
            return self.ctx_axis
        return None

    @property
    def active_ep_axis(self) -> str | None:
        """``ep_axis`` if it names a mesh axis of size > 1, else None."""
        if (self.ep_axis and self.ep_axis in self.axis_names
                and self.axis_size(self.ep_axis) > 1):
            return self.ep_axis
        return None

    @property
    def ctx_size(self) -> int:
        ax = self.active_ctx_axis
        return self.axis_size(ax) if ax else 1

    @property
    def ep_size(self) -> int:
        ax = self.active_ep_axis
        return self.axis_size(ax) if ax else 1

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis) if self.model_axis else 1

    @property
    def pipe_size(self) -> int:
        return self.axis_size(self.pipe_axis) if self.pipe_axis else 1

    @property
    def dp_size(self) -> int:
        ax = self.active_data_axis
        n = self.axis_size(ax) if ax else 1
        if self.pod_axis:
            n *= self.axis_size(self.pod_axis)
        return n

    # ---- parameter spec rules --------------------------------------------
    def param_spec(self, path: str, shape: tuple[int, ...]) -> P:
        """Rules keyed on the parameter's path suffix (``/`` or ``.``
        separated).  Stacked parameters (``blocks/...``) carry a leading
        layer dim.  A dim that does not divide by its axes' size is
        replicated (e.g. tiny per-head scalars)."""
        path = path.replace(".", "/")
        stacked = path.startswith("blocks/")
        name = path.rsplit("/", 1)[-1]
        logical = _PARAM_RULES.get(name, tuple(None for _ in shape))
        if stacked:
            logical = (None,) + tuple(logical)
        logical = tuple(logical)[: len(shape)]
        logical = logical + (None,) * (len(shape) - len(logical))
        phys = []
        for dim, l in zip(shape, logical):
            ax = self.phys(l)
            if ax is None:
                phys.append(None)
                continue
            sz = 1
            for a in (ax,) if isinstance(ax, str) else ax:
                sz *= self.axis_size(a)
            phys.append(ax if dim % sz == 0 else None)
        return P(*phys)


_PARAM_RULES = {
    # attention
    "wq": ("fsdp", "heads"), "wk": ("fsdp", "heads"),
    "wv": ("fsdp", "heads"), "wo": ("heads", "fsdp"),
    # dense mlp
    "w_up": ("fsdp", "ff"), "w_gate": ("fsdp", "ff"),
    "w_down": ("ff", "fsdp"),
    # moe
    "router": (None, None),
    "we_up": ("experts", "fsdp", None), "we_gate": ("experts", "fsdp", None),
    "we_down": ("experts", None, "fsdp"),
    "ws_up": ("fsdp", "ff"), "ws_gate": ("fsdp", "ff"),
    "ws_down": ("ff", "fsdp"),
    # ssm
    "in_z": ("fsdp", "model"), "in_x": ("fsdp", "model"),
    "in_B": ("fsdp", None), "in_C": ("fsdp", None),
    "in_dt": ("fsdp", "model"), "out_proj": ("model", "fsdp"),
    "conv_w": (None, "model"),
    "a_log": ("model",), "d_skip": ("model",), "dt_bias": ("model",),
    "ssm_norm": ("model",),
    # embeddings / head / norms
    "embed": ("vocab", "fsdp"), "lm_head": ("fsdp", "vocab"),
    "norm": (None,), "norm_mixer": (None,), "norm_ffn": (None,),
    "norm_final": (None,),
}

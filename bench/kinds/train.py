"""The window loop of a training cell: the port's policy train program
(``train.step.build_train_step(cfg, AdamW, policy=Policy(mesh))``: ZeRO-3
over data, tensor and sequence parallelism over model) on the cell's
(data, model) mesh, one rank a card (``harness.on_ranks``).

Set-up: each rank draws the benchmark's weights whole, keeps its blocks
(``shard_train_params``), builds the one train state and step, and drives
them from the seed through their first three steps, which the comparison
reads: each step's loss, the first gradient as AdamW got it (its first
moment over 1 - b1) and each parameter's change over the three, each leaf's
norm taken over the whole leaf, across the ranks.  The same state and step
then run the window: every rank steps on the same global batches, fresh
rows of the token stream, until rank 0's clock has passed ``--seconds``
(rank 0 tells the others before each step).  ``train_tokens_per_s`` is the
global tokens of every step over rank 0's window, ended by a synchronise.
After the window (``--trace 1``) three steps split by CUDA events into
forward, backward and update, then two steps under the profiler on every
rank.  Then the program's state is freed (its ranks end) and the float32
reference runs the same three steps on the same weights and rows, its
layers spread over the cell's cards.
"""

from __future__ import annotations

import gc
import math

import torch
import torch.distributed as dist
from repro_torch.core.compile import local_blocks
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models.common import spec_axes
from repro_torch.models.model import shard_train_params, train_param_specs
from repro_torch.optim import AdamW
from repro_torch.sharding import Policy
from repro_torch.train.step import build_train_step, init_train_state

import harness
from reference import check
from reference.inputs import make_leaf, make_weights, train_batch


class _Port:
    value = 0


def join_world(device, mesh, alone: bool):
    """The (data, model) ``mesh`` as a policy; ``alone``: this process is
    the one rank, and joins a world of one first."""
    if alone and not dist.is_initialized():
        launch_mesh.init_world(0, 1, device=device.type, port=_Port())
    return Policy(launch_mesh.make_host_mesh(tuple(mesh), device=device.type,
                                             all_ranks_group=True))


def leave_world():
    if dist.is_initialized():
        dist.destroy_process_group()


def agree(go: bool, device) -> bool:
    """Rank 0's ``go``, on every rank."""
    if dist.get_world_size() == 1:
        return go
    flag = torch.tensor([int(go)], device=device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


class Trainer:
    """One rank's train state and step, driven from the seed through the
    checked steps: ``prog`` holds their readings, the same on every
    rank."""

    def __init__(self, cell, run, policy, stages=None):
        conf, tr, dev = cell.config, cell.traffic, run.device
        stages = stages or (lambda name: None)
        self.cell, self.run, self.policy = cell, run, policy
        cfg = harness.program_config(conf)
        opt = AdamW(lr=lambda count: tr["lr"], b1=tr["b1"], b2=tr["b2"],
                    eps=tr["eps"], weight_decay=tr["weight_decay"])
        self.clock = harness.PhaseClock()
        step = build_train_step(cfg, opt, policy=policy,
                                max_grad_norm=tr["clip"],
                                phase_hook=self.clock)
        self.step_fn = run.faults.get("step", lambda s: s)(step)
        self.specs = train_param_specs(cfg, policy)
        whole = make_weights(conf, run.seed, dev)
        self.state = init_train_state(
            cfg, shard_train_params(cfg, whole, policy), opt)
        del whole
        release_cache(dev)
        stages("weights")
        self.batches = []
        self.i = 0
        self.prog = self._checked_steps()
        stages("checked_steps")

    def batch(self, i: int) -> dict:
        tr = self.cell.traffic
        while len(self.batches) <= i:
            self.batches.append(train_batch(
                self.run.seed, len(self.batches), tr["batch"], tr["seq"],
                self.cell.config["vocab_size"]))
        return self.batches[i]

    def step(self):
        self.state, met = self.step_fn(self.state, self.batch(self.i))
        self.i += 1
        return met

    def whole_norms(self, blocks) -> dict:
        """The norm of each whole leaf from ``blocks``, (leaf, this rank's
        block) pairs: the squares summed over the ranks, each block counted
        once however many ranks hold it."""
        pol = self.policy
        world = math.prod(pol.axis_size(a) for a in pol.axis_names)
        sq = {}
        for k, block in blocks:
            parts = math.prod(pol.axis_size(a) for entry in self.specs[k]
                              for a in spec_axes(entry))
            sq[k] = block.float().pow(2).sum() * parts / world
        keys = sorted(sq)
        total = torch.stack([sq[k] for k in keys])
        if dist.get_world_size() > 1:
            dist.all_reduce(total)
        return dict(zip(keys, total.sqrt().tolist()))

    def start_block(self, k):
        """This rank's block of leaf ``k`` as the seed drew it."""
        conf, run = self.cell.config, self.run
        return local_blocks({k: self.specs[k]},
                            {k: make_leaf(conf, k, run.seed, run.device)},
                            self.policy)[k]

    def _checked_steps(self) -> dict:
        """The first steps, the window's own call and feed, from the seed:
        each loss, the first gradient as AdamW got it and each leaf's
        change."""
        prog = {"loss": []}
        self.step_s = []
        for i in range(check.STEPS):
            t = harness.now()
            prog["loss"].append(float(self.step()["loss"]))
            self.step_s.append(harness.now() - t)
            if i == 0:
                b1 = self.cell.traffic["b1"]
                prog["grad"] = {k: g / (1 - b1) for k, g in self.whole_norms(
                    self.state["opt"]["m"].items()).items()}
        with torch.no_grad():
            prog["change"] = self.whole_norms(
                (k, p.float() - self.start_block(k).float())
                for k, p in self.state["params"].items())
        return prog

    def release(self):
        """Free the program's state and step."""
        del self.state, self.step_fn
        release_cache(self.run.device)


def release_cache(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def rank_window(rank, mesh, *, cell, run) -> dict:
    """One rank of a run: set-up, the window and, with ``run.trace``, the
    phases and the profiled stretch."""
    run = harness.rank_run(run, rank)
    run.faults.get("rank", lambda: None)()
    stages = harness.Stages(run.t0)
    stages("rank_start")
    policy = join_world(run.device, cell.workload["mesh"], mesh is None)
    try:
        return _rank_window(rank, cell, run, policy, stages)
    finally:
        if mesh is None:
            leave_world()


def _rank_window(rank, cell, run, policy, stages) -> dict:
    tr, dev = cell.traffic, run.device
    trainer = Trainer(cell, run, policy, stages)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    want = check.STEPS + math.ceil(1.5 * run.seconds
                                   / min(trainer.step_s[1:])) + 8
    trainer.batch(want)
    agree(True, dev)

    # the window
    harness.sync(dev)
    t_w = harness.now()
    stages("window")
    steps = skipped = 0
    ends = []
    while agree(harness.now() - t_w < run.seconds, dev):
        skipped += int(trainer.step()["skipped"])
        steps += 1
        ends.append(harness.now())
    harness.sync(dev)
    h = steps // 2
    halves = [h / (ends[h - 1] - t_w), (steps - h) / (ends[-1] - ends[h - 1])
              ] if h else []
    out = {"steps": steps, "skipped": skipped,
           "elapsed_s": harness.now() - t_w, "setup_s": t_w - run.t0,
           "stages": stages.marks, "steps_per_s_halves": halves,
           "prog": trainer.prog}

    if run.trace:
        phases = {}
        trainer.clock.on = True
        for _ in range(3):
            trainer.step()
            for k, ms in trainer.clock.close().items():
                phases.setdefault(k, []).append(ms)
        trainer.clock.on = False

        def stretch():
            for _ in range(2):
                trainer.step()

        st = harness.profile_stretch(stretch, run.tmp, rank)
        st["steps"] = 2
        out.update(phases=phases, stretch=st)
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    trainer.release()
    return out


def run(cell: harness.Cell, run: harness.Run) -> dict:
    ranks = harness.on_ranks(rank_window, cell, run)
    tr, r0 = cell.traffic, ranks[0]
    tokens = r0["steps"] * tr["batch"] * tr["seq"]
    out = {"attempted": r0["steps"], "failed": r0["skipped"],
           "notes": {"stages": r0["stages"],
                     "steps_per_s_halves": r0["steps_per_s_halves"]},
           "e2e": {"train_tokens_per_s": tokens / r0["elapsed_s"],
                   "setup_s": r0["setup_s"]},
           "readings": {"kind": "train", "chips": cell.chips,
                        "cfg": cell.config, "traffic": tr,
                        "window": {"steps": r0["steps"],
                                   "elapsed_s": r0["elapsed_s"],
                                   "tokens": tokens}}}
    if run.trace:
        sts = [r["stretch"] for r in ranks]
        out["readings"].update(phases=r0["phases"], stretches=sts)
        out["device_extra"] = harness.device_seconds(sts)
        out["breakdown"] = harness.breakdown(sts[0])
    if "memory_peak_bytes" in r0:
        out["memory_peak_bytes"] = max(r["memory_peak_bytes"] for r in ranks)
    out["checks"] = harness.checks(
        check.train_numbers(r0["prog"], reference(
            cell.config, tr, run.seed, harness.cell_devices(cell, run))),
        cell.limits)
    return out


def reference(conf, tr, seed, devices, **kw) -> dict:
    """The float32 reference's readings of the three checked steps, its
    layers spread over ``devices``."""
    batches = [{k: torch.as_tensor(a, device=devices[0]).long()
                for k, a in train_batch(seed, i, tr["batch"], tr["seq"],
                                        conf["vocab_size"]).items()}
               for i in range(check.STEPS)]
    with harness.fp32():
        return check.train_steps(
            conf, lambda k, d: make_leaf(conf, k, seed, d), batches, tr,
            devices=devices, **kw)

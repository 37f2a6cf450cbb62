"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
card and hold each hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Five paths are served, glm4-9b (dense attention), mamba2-370m (SSM),
jamba-v0.1-52b (SSM and attention mixers, MoE FFNs), pixtral-12b and
musicgen-medium (stub frontends: embeds in place of tokens), glm4-9b
also from a checkpoint, and glm4-9b, jamba-v0.1-52b and mamba2-370m
sharded over a (data, model) mesh; glm4-9b is
trained, also with its sequence over a ctx axis (ring attention), and
through checkpoints, injected faults and a mesh shrink; mamba2-370m is
trained at all 48 layers; and the dry run's predictions (kernel calls,
peak memory, bound time, traced on ``meta``) are held against three of
those cells; glm4-9b is also trained by the reference's production step
(ZeRO-3 over data, TP/SP over model) at mesh (1, 1), and phi3-medium-14b
at (1, 3) where three cards exist, its 40 query heads split 14, 13, 13;
there, too, glm4-9b and mamba2-370m are served and mamba2-370m trained
at (1, 3), where no width of theirs divides by 3.
Phases, each printing JSON lines; any failure raises and exits non-zero:

0. device: require CUDA; print the card's name and power limit.
1. build: compile the CUDA sources with nvcc (Triton compiles on launch).
2. kernels: flash attention (CUDA) at glm4-9b shapes and RMSNorm (Triton)
   at every width the two models give it (4096; 1024 and 2048), against
   their plain versions on the card, and the SSD chunk scan (CUDA),
   y and final state, against the naive recurrence and the chunked plain
   form at the reference's sweep shapes, mamba2's heads at a ragged S = 200
   and a prompt shorter than a chunk, ragged lengths included, and at the
   serving shape with dt and A drawn as mamba2's block makes them.  bf16
   flash attention and SSD inputs take the tensor-core kernels, fp32 ones
   the 3xTF32 kernels (TF32 tensor cores, split products); both routes
   are also checked at every head dim (flash, 112 included) and every
   head dim and chunk tile (SSD), on strided views (bf16 refusing a
   misaligned stride, fp32 reading unaligned ones), each call's route is
   checked, and empty head blocks (H = 0, a rank of a model axis larger
   than the head count) return the plain versions' shapes, launching
   nothing.  Both flash routes at kimi-k2-1t-a32b's head dim 112 (q
   (1,1024,64,112), k/v (1,1024,8,112), causal) against the plain
   version, timed beside it and SDPA.
   Then each kernel's (per route), its plain version's and a library
   call's times at its serving shape, beside the bound the card's data
   sheet gives (the fp32 rows: three TF32 passes, and the fp32 CUDA
   cores beside it) and the achieved TFLOP/s and GB/s.
3. parity: each model at full width cut to 2 layers, fp32, served on the
   card (3xTF32 kernels) and on the host (plain versions): logits and
   caches (K/V, conv and SSM states) within 1e-3, identical greedy tokens.
   Then in bf16 on the card (tensor-core kernels) against the host's fp32
   forward from the same bf16-rounded parameters: prefill logits and caches
   within BF16_PARITY_TOL of their scale, the same first greedy token.
4. serve: each full model in bf16 through ``repro_torch.launch.serve.main``
   (glm4-9b: 40 layers, batch 4, prompt 1024, 32 steps; mamba2-370m: 48
   layers, batch 8, prompt 2048, 32 steps), with the kernels' launch counts
   set to 0 just before and read just after the measured run: every flash
   and SSD launch on the tensor-core route.
5. decode share: one decode step of each model timed eagerly and replayed
   from a CUDA graph, to show how much of an eager step the device is busy.
6. backward: each kernel and route at its serving shape, gradients of a
   fixed random cotangent through ``ops.<kernel>`` (the kernel's forward,
   then the backward that recomputes through the plain version, as
   ``repro/kernels/ops.py`` does) against the plain function's own
   autograd, within the forward's pins; the backward timed by CUDA events.
7. train parity: glm4-9b at full width cut to 2 layers, fp32, batch 2,
   seq 200 (a ragged flash tile): loss and every grad leaf card (3xTF32
   kernels) vs host, then one AdamW step through the train step on the
   card against the host's update applied leaf by leaf (host memory).
8. train: glm4-9b in bf16 at full width cut to 8 layers, batch 4, seq 1024,
   5 AdamW steps through ``repro_torch.launch.train.train`` (the loop of
   ``train/loop.py``), launch counts set to 0 just before and read just
   after: 8 flash launches (tensor-core route) and 17 norms a step.  Per
   step loss, grad norm, skip flag and time; the median step, tokens/s,
   the model-FLOPs share of the bf16 peak, peak memory, and one more step
   split into forward, backward and optimizer by CUDA events.  Then one
   step of ``build_train_step`` timed for phase 18, its launches and peak
   memory above what was allocated before the train state.
9. dist: the paper's parallel primitives, every ``LinearOp`` and its
   adjoint, and the memory operators on CUDA tensors, through
   ``repro_torch.launch.dist_check`` in a world of
   ``torch.cuda.device_count()`` ranks over NCCL (one rank per card; one
   rank on a one-card machine), spawned by ``launch.mesh.spawn``: Eq. 13
   (a) and (b) at the reference's pins on glm4-9b's activation block (4,
   1024, 4096) fp32 sharded on seq, its FFN weight (4096, 13696) and
   64M-element buffers; each collective's forward timed by CUDA events.
   One line ``{"dist": {...}}``; no kernel of this repo runs in it.
10. region: the region layer (``core/compile.py::dist_jit``), spawned over
   NCCL with one rank per card, on a (1, 1) mesh (a (2, 2) mesh where 4
   cards or more exist).  (a) The paper's §5 LeNet-5 experiment through
   ``examples/lenet5_distributed_torch.py``'s ``main`` at the published
   widths (6/16 channels, 120/84/10): distributed vs sequential forward
   and grads at the initial parameters within the reference's pins (2e-4,
   2e-3), 60 SGD steps at batch 64 to equal accuracies (within 0.02), ms
   a step of each.  (b) glm4-9b's attention+MLP sublayer at full width
   (d_model 4096, 32/2 heads of 128, d_ff 13696; batch 2, seq 1024)
   through ``sublayer_apply`` with an ``explicit_tp`` policy (the region,
   its ring matmuls and sharded RMSNorm) against the ordinary
   ``sublayer_apply`` on the card: fp32 forward within 2e-4 and grads
   within 5e-4 (3xTF32 flash), bf16 within BF16_PARITY_TOL of scale
   (tensor-core flash); exactly one flash launch a sublayer on the dtype's
   route, counted around the region run; forward+backward of both timed by
   CUDA events in turns (region, ordinary, ordinary, region) and by their
   device activity (``torch.profiler``).  One line ``{"region": {...}}``.
11. hybrid: the pipeline executor and the hybrid DP x pipe x TP train step
   (``core/pipeline.py``, ``train/step.py::build_hybrid_train_step``) over
   NCCL, one rank per card: at mesh (1, 1, 1) on one card (one stage, M
   microbatches, the rematerialized backward, the fp32 accumulators, the
   drain tail and the guard's one-bit all-reduce), at (dp, pipe, model) =
   (1, 2, 2) with explicit TP where 4 cards or more exist (stage hops and
   TP rings between cards).  Launch counts per rank follow PERF.md §6.  (a) glm4-9b at full width cut to 2
   layers, fp32, B 4, S 1024, M 4, 1F1B and fill-drain, against the
   port's single-device ``loss_and_grads`` over the same batch at the
   reference's pins (loss rtol 2e-5, every grad rtol and atol 5e-4) and
   each grad leaf within PARITY_TOL of its largest |value|, as phase 7.
   (b) glm4-9b bf16 at full width cut to 8 layers, B 4, S 1024, M 4, 1F1B,
   5 AdamW steps through ``launch.train.train_hybrid_rank`` (the CLI's
   per-rank path), launch counts set to 0 just before and read just after
   (on one card M x L flash launches, tensor-core route, and M x (2L + 1)
   norms a step); the median step, tokens/s, peak memory, the bubble, and
   one more step split by CUDA events into F, B and idle ticks, the
   boundary shifts, the drain tail and the optimizer.  (c) one step
   poisoned through the executor's ``grad_fault_hook`` on the last rank
   only: skipped on every rank, params and moments bitwise unchanged.
   One line ``{"hybrid": {...}}``.
12. moe: MoE and expert parallelism, jamba-v0.1-52b at its published
   widths.  (a) Each kernel against its plain version at jamba's shapes:
   the bf16 SSD scan (B 4, S 1024, H 128, P 64, N 16, chunk 64), RMSNorm
   at 4096 and 8192 (the gated norm over d_inner), bf16 flash attention
   with GQA group 4 (32 over 8 heads); their times at those shapes.  (b)
   The MoE FFN at full width (E 16, top-2, d 4096, h 14336, 2.82B
   parameters), fp32, T 512, card vs host: y and every grad within
   PARITY_TOL of scale, aux within 1e-5 relative, the top-k choices and
   the kept slots equal.  (c) The served model (depth cut 32 -> 8, one
   period), bf16, each sublayer on the card against the host's fp32
   sublayer on the same input (B 1, prompt 64): within BF16_PARITY_TOL of
   scale; the host holds one sublayer's weights at a time (``free -g``
   printed first).  (d) That model served through ``ServeEngine``, B 4,
   prompt 1024, 32 greedy steps, launch counts set to 0 just before and
   read just after: flash 1 and SSD 7 (tensor cores), RMSNorm 792; the
   rates, peak memory and a decode step's busy share.  (f) The MoE FFN
   sub-layer at full width, bf16, B 2, S 1024, forward and forward +
   backward by CUDA events.  (e) The MoE train path at small widths,
   fp32: reduced kimi and llama4 card vs host (loss and every grad at
   1e-4), reduced jamba's loss and each sublayer's vjp; the hybrid step
   on tests/md/test_moe_md.py's ep-grads config (at head dim 16, which
   the flash kernels take) over NCCL at mesh (1, 1,
   1, 1, 1) against the single-device step at that file's pins, and at
   (1, 1, 1, 1, 4) and (1, 1, 1, 2, 2) where 4 cards exist (which also
   time (f) at ep 4); on one card those say they skip and why.  One line
   ``{"moe": {...}}``.
13. ring: context parallelism, the KVRingShift ring of
   ``core/ring_attention.py`` (plain torch, as the reference's, which
   refuses its flash kernel under ctx).  (0) kimi-k2-1t-a32b's attention
   sub-layer at full width (d_model 7168, 64 heads of 112 over 8), bf16
   prefill B 1, S 1024 on the card (one tensor-core flash launch) against
   the host's fp32 run: within BF16_PARITY_TOL of scale; its MoE FFN (384
   experts) does not fit one card.  (a) glm4-9b's attention widths, q
   (2,4096,32,128), k/v (2,4096,2,128), chunk 512, cut into cp = 4
   virtual ranks of 1024, each composed from ``ring_hop`` in the
   reference's hop order: output and q/k/v vjp against the plain
   ``blockwise_attention`` on the whole sequence, fp32 (TF32 off) at the
   reference's pins scaled by the output's magnitude, bf16 within the
   bf16 pin of scale; ``ring_attention`` itself on a live one-rank ctx
   axis over NCCL.  (b) One hop (B 4, Sq = Skv = 1024, bf16) forward and
   forward + backward by CUDA events beside the flash kernel on the same
   block, and one virtual rank's peak memory against
   ``attention_working_set_bytes(..., cp=4)``.  (c) The ctx train path on
   one rank (glm4-9b full width cut to 2 layers, bf16), the counts set to
   0 just before and read just after: flash 0, RMSNorm 2L + 1.  (d) Where
   4 cards exist, the hybrid step with a live ctx axis at (dp, pp, cp,
   tp, ep) = (1, 1, 4, 1, 1) and (1, 1, 2, 2, 1), one NCCL rank per card:
   fp32 glm4-9b cut to 2 layers, B 2, S 2048, M 2 against the
   single-device step (the reference's pins), then bf16 cut to 8 layers,
   B 4, S 4096, M 4, 5 steps through ``launch.train.train_hybrid_rank``
   (no flash launch; RMSNorm as phase 11 counts it): step time, tokens/s,
   peak memory a rank; on one card each mesh records that it skipped and
   why.  One line ``{"ring": {...}}``.
14. resilience: checkpoints, fault injection and elastic recovery
   (``checkpoint/ckpt.py``, ``resilience/inject.py``, ``train/loop.py``),
   checkpoints under the gitignored ``build/ckpt`` (the filesystem and its
   free bytes printed first; too few raise).  (a) Phase 8's cell (glm4-9b
   at full width cut to 8 layers, bf16 params and fp32 AdamW moments,
   28.7 GB; B 4, S 1024): 2 steps, ``save``, ``restore_latest_verified``
   beside the live state, the snapshot, crc32, writes, reads with their
   checks and host-to-device copies timed apart; the restored state
   bitwise the saved one, and step 3 from each (one step run twice from
   the same state) bitwise equal in loss and every leaf.  (b) Cut to 2
   layers and a vocabulary of 8192 (4.75 GB; the machine's disk takes 45
   GiB of writes a call), 5 steps through ``launch.train.train`` with
   ``fault_plan="poison=3,crash=4,corrupt=bitflip"``, async saves every 2
   steps, keep 2: step 3 skipped, the crash at 4 damaging step 4's
   checkpoint, its quarantine, the restart from step 2; final loss and
   every leaf bitwise the fault-free run's, health restarts 1,
   quarantined 1, skipped 1, the counts set to 0 just before and read
   just after (L flash and 2L + 1 norms a step executed).  (c) Where 4
   cards exist, ``train_hybrid_rank`` at (dp, pp, cp, tp, ep) = (2, 1, 1,
   2, 1), B 8, M 2: first (b)'s config with an ``OSError`` raised by rank
   3's save of step 2 alone, carried to every rank by the next step's
   guard all-reduce, one restart of all four from step 2's checkpoint,
   bitwise the clean run's (two saves of 4.75 GB); then glm4-9b at depth
   2 with ``elastic`` and ``shrink=3:data``: ranks 2-3
   leave, ranks 0-1 finish at (1, 1, 1, 2, 1) with virtual_dp 2, bitwise
   the clean 4-card run's; on one card it records that it skipped.  One
   line ``{"resilience": {...}}`` a part.  Before (a) deletes its
   checkpoint, ``launch.serve.main(["--ckpt-dir", ...])`` serves it (B 4,
   prompt 64, 8 greedy steps): the restored params bitwise the live ones,
   its tokens equal to an engine's on the live params (no disk writes).
15. frontends: the stub frontends (``{"embeds": (B, S, d)}`` in place of
   tokens).  The bf16 flash kernel at musicgen-medium's head dim 64 and
   prefill shape against its plain version; pixtral-12b and
   musicgen-medium at full width cut to 2 layers, prefill from random
   embeds (B 2, S 200) card vs host: fp32 logits and caches within
   PARITY_TOL and 4 greedy decode steps equal, bf16 within
   BF16_PARITY_TOL of scale and the first token equal; then each in bf16
   at its published widths (pixtral-12b: 40 layers, d 5120, 12.25B
   parameters; musicgen-medium: 48 layers, d 1536), B 4 x 1024 random
   embeds prefilled and 32 greedy steps, the launch counts set to 0 just
   before and read just after (L flash, (2L + 1) norms a forward):
   prefill and decode tok/s and peak memory.
16. serve_sharded: sharded serving (``ServeEngine(cfg, params, policy)``
   over a (data, model) mesh) at (1, 1), one NCCL rank, each model in
   bf16 at full width against the engine with no policy on
   ``shard_params``' cut of the same parameters: glm4-9b cut to 8 layers
   (B 4, prompt 1024, 32 steps) under ``kvdim`` and ``kvseq``;
   jamba-v0.1-52b cut to one 8-layer period (SSM mixers on their heads,
   MoE FFNs on their experts, attention; B 4, prompt 1024) and
   mamba2-370m, all 48 layers (B 8, prompt 2048), under ``kvdim``.  The
   unsharded engine runs its norms with the sharded engine's arithmetic
   in plain torch for the comparison (at random weights one bf16
   rounding at each norm carries through mamba2's 48 layers to the
   logits' scale; the share it moves them by is printed): the prefill's
   and every teacher-forced decode step's logits within BF16_PARITY_TOL
   of scale (jamba's unsharded engine routed as the sharded one was,
   every swap of a top-k expert a near-tie), its greedy tokens equal (a
   first difference is tolerated only at a near-tie); the launch counts of the
   measured request (flash and SSD once per layer of their kind on the
   tensor cores, one RMSNorm a forward, the final norm where the residual
   is whole); prefill and decode tok/s and peak memory.  The 4-card
   cells at (1, 4), mistral-large-123b, jamba-v0.1-52b (all 32 layers)
   and glm4-9b (2 K/V heads under TP 4), run in
   ``tools/serve_phase_torch.py --four-card-meshes`` (``serve_meshes``).
   One line ``{"serve_sharded": {...}}``.
17. train mamba2: phase 8 for mamba2-370m at all 48 layers (state 4.4 GB
   at 12 bytes a parameter), bf16, B 8, S 2048 (the serve cell's shape),
   5 AdamW steps: 48 SSD launches (tensor-core route) and 97 norms a
   step; its backward recomputes through the plain SSD scan.  Run right
   after phase 8.
18. dryrun: the dry run held against the card (right after phase 17).
   ``repro_torch.launch.dryrun.world1_cell`` traces on ``meta``, in this
   process and after the card has run them, three cells: serve glm4-9b
   (40 layers, B 4, prompt 1024: prefill and one decode step, measured
   here), train glm4-9b at 8 layers (B 4, S 1024) and train mamba2-370m
   (the steps phases 8 and 17 measured; ~60 s of host tracing).  For
   each: the traced kernel calls equal to the card's launches by kernel
   and route, the predicted peak within 10% of the card's
   ``max_memory_allocated()`` above its baseline, and the roofline's bound
   time beside the measured time as a share (no pass or fail).  One
   ``dryrun_vs_card`` line a cell.
19. zero3: the policy train program (``build_train_step(cfg, opt,
   policy=Policy(mesh))``: ZeRO-3 over data, tensor and sequence
   parallelism over model, remat per superblock) spawned as one NCCL
   rank at mesh (1, 1): glm4-9b at full width cut to 2 layers in fp32,
   its loss and every gradient leaf within 1e-6 of scale of
   ``build_train_step`` without a policy; then 5 bf16 steps of 8 layers
   (B 4, S 1024) through ``launch.train.train(..., mesh=(1, 1))``, the
   launch counts exact (2L flash, 4L + 1 RMSNorm a step: the remat
   forward runs again in the backward), and one more step split by CUDA
   events, its peak memory and collectives.  Where four cards exist
   (``tools/zero3_phase_torch.py --four-card-meshes``, ``zero3_meshes``):
   glm4-9b at all 40 layers from the per-rank initialiser at (4, 1) and
   (2, 2), B 8, S 1024, 5 steps, the 2-layer fp32 parity at (2, 2), each
   mesh's peak within 2% of ``launch.dryrun.mesh_cell``'s prediction.
   One line ``{"zero3": {...}}`` (``{"zero3_mesh": ...}`` a 4-card mesh).
20. uneven_heads: query heads the model axis does not divide, split by
   the paper's balanced decomposition (``models.attention.head_block``).
   (a) the bf16 flash kernel at every per-rank shape that TP 16 gives
   llama4-maverick-400b-a17b and phi3-medium-14b (40 heads: 3 and 2 a
   rank), phi4-mini-3.8b and musicgen-medium (24: 2 and 1), B 4, S 1024,
   causal, K/V laid out as ``_kv_of_local_heads`` gives them, against
   its plain version at phase 2's bf16 pin, each timed beside the plain
   version, SDPA and its bound.  (b) where three cards exist
   (``tools/uneven_heads_phase_torch.py`` on a 4-card machine):
   phi3-medium-14b at (data, model) = (1, 3), 14, 13 and 13 query heads,
   on three NCCL ranks: the 2-layer fp32 parity against one card's step
   at PARITY_TOL, then 5 bf16 steps of 8 layers (B 4, S 1536) from the
   per-rank initialiser, every rank's losses equal and finite, each
   rank's peak within 2% of ``launch.dryrun.mesh_cell`` traced as that
   rank, its kernel launches and its collectives a step (count and
   bytes) equal to the trace's.  One line ``{"uneven_heads": {...}}``.
21. uneven_widths: widths the model axis does not divide (d_model,
   head_dim under ``kvdim``, d_ff, the SSM heads and their d_inner
   channels), split by the balanced decomposition.  (a) the bf16 flash
   kernel at the per-rank shapes TP 3 gives glm4-9b (11, 11 and 10 query
   heads, B 4, S 1024) and the bf16 SSD scan at mamba2-370m's 11 and 10
   SSM heads a rank (B 8, S 2048, chunk 64) against their plain versions
   at phase 2's bf16 pins, each timed beside its plain version (and SDPA)
   and its bound.  (b) and (c) where three cards exist
   (``tools/uneven_widths_phase_torch.py`` on a 4-card machine), on three
   NCCL ranks at (data, model) = (1, 3): glm4-9b (40 layers, B 4, prompt
   1024) and mamba2-370m (48 layers, B 8, prompt 2048) served 32 greedy
   steps under ``kvdim`` and ``kvseq`` from the per-rank initialiser
   (launch counts exact, rates, peak memory), cut to 2 layers in fp32
   and at full depth in bf16 against one card's engine in the same
   process (``serve_mesh_parity``); mamba2-370m trained 5 bf16 steps of
   48 layers (B 8, S 2048) after the 2-layer fp32 parity against one
   card's step (``zero3_spawn``); each rank's serving prefill and first
   decode step and its train step held to ``launch.dryrun.mesh_cell``
   traced as that rank: kernel calls and collectives (count and bytes)
   equal, peak within 2%.  One line ``{"uneven_widths": {...}}``.

Kernel times are device times: the calls are replayed from a CUDA graph,
so the host's launch cost is not in them.  Backward and train-step times
are CUDA-event and host-clock times around eager calls.

The line before the last lists the kernels; the last line is
``{"ok": true, "device": {...}}``.  The weights are random, from a seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "examples"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

import lenet5_distributed_torch as lenet_example  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.checkpoint import ckpt as ckpt_lib  # noqa: E402
from repro_torch.configs import (ModelConfig, get_config,  # noqa: E402
                                 reduced)
from repro_torch.core import linop  # noqa: E402
from repro_torch.core import primitives as prim  # noqa: E402
from repro_torch.core.compile import region  # noqa: E402
from repro_torch.core.partition import shard_offsets  # noqa: E402
from repro_torch.core import ring_attention as ring  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.cost import kernel_cost  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.launch import dist_check, dryrun, serve  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import (forward,  # noqa: E402
                                from_pipeline_params, init_cache,
                                init_params, init_pipeline_params,
                                init_rank_params, moe, shard_params)
from repro_torch.models.attention import (attention_block,  # noqa: E402
                                          attn_init, head_block,
                                          local_kv_heads)
from repro_torch.models import blocks as model_blocks  # noqa: E402
from repro_torch.models.blocks import (sublayer_apply,  # noqa: E402
                                       sublayer_init)
from repro_torch.models.common import (mlp_apply, rmsnorm,  # noqa: E402
                                       subtree)
from repro_torch.models.model import (DTYPES,  # noqa: E402
                                      shard_train_params,
                                      train_param_specs)
from repro_torch.models.ssm import ssm_block  # noqa: E402
from repro_torch.optim import global_norm, make_optimizer  # noqa: E402
from repro_torch.resilience import nonfinite_flag  # noqa: E402
from repro_torch.roofline import analysis as roofline  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.sharding import Policy  # noqa: E402
from repro_torch.train import (batch_to_device,  # noqa: E402
                               build_hybrid_train_step,
                               build_hybrid_value_and_grad, build_loss_fn,
                               build_train_step, cross_entropy,
                               init_train_state, loss_and_grads)

GLM, MAMBA = "glm4-9b", "mamba2-370m"
SERVE = {GLM: {"batch": 4, "prompt_len": 1024, "steps": 32},
         MAMBA: {"batch": 8, "prompt_len": 2048, "steps": 32}}
# The reference's own pins (tests/test_kernels.py:36-38, 147).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
NORM_CASES = [        # (rows, d): each d is its own Triton specialisation
    (4, 4096), (4096, 4096), (1000, 4096),   # glm4-9b: decode, prefill rows
    (8, 1024), (16384, 1024),                # mamba2-370m norm_mixer/final
    (8, 2048), (16384, 2048),                # mamba2-370m gated ssm_norm
]
SSD_CASES = [         # (B, S, H, P, N, chunk)
    (1, 128, 2, 16, 16, 32),     # the sweep of tests/test_kernels.py:95-100
    (2, 256, 4, 64, 32, 64),
    (1, 64, 1, 32, 128, 16),
    (1, 128, 8, 64, 64, 128),
    (2, 200, 32, 64, 128, 64),   # mamba2-370m heads, ragged last chunk
    (2, 40, 32, 64, 128, 64),    # a prompt shorter than one chunk
]
PARITY_TOL = 1e-3
# bf16 card forward vs fp32 host forward: each matmul output, norm and
# residual add rounds to bf16 (relative 2^-9), ~15 times over 2 layers, so
# logits and caches differ by ~1-2% of their scale; 5% of the largest |value|
# passes that and fails a broken kernel, whose error is of the scale itself.
BF16_PARITY_TOL = 5e-2
FLASH_TC_CASES = [    # (B, Sq, Skv, H, KH), each hd, bf16 and fp32
    (1, 128, 128, 2, 2),
    (2, 200, 200, 8, 2),         # ragged last q tile and KV tile
    (1, 72, 200, 4, 1),          # Sq != Skv, non-causal only
]
SSD_TC_CASES = [      # (P, chunk tile, S), bf16 and fp32, B 2, H 8, N 128
    (P, tile, S) for P in (16, 32, 64) for tile in (16, 32, 64, 128)
    for S in (200, 40)]  # a ragged last chunk; a prompt shorter than some
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "tf32x3"}
BACKWARD = "plain recompute, as repro/kernels/ops.py"
# the train cell: glm4-9b's published widths, depth cut from 40 to 8 layers
TRAIN = {"layers": 8, "batch": 4, "seq": 1024, "steps": 5, "lr": 1e-3}
# phase 17: mamba2-370m at all 48 layers, the serve cell's shape
TRAIN_MAMBA = {"layers": 48, "batch": 8, "seq": 2048, "steps": 5, "lr": 1e-3}
TRAINS = {GLM: TRAIN, MAMBA: TRAIN_MAMBA}
# phase 18: the one-device dry run on meta of three cells the card runs,
# (kind, arch, layers, batch, seq)
DRYRUN_CELLS = {
    f"serve {GLM}": ("serve", GLM, 40, SERVE[GLM]["batch"],
                     SERVE[GLM]["prompt_len"]),
    f"train {GLM}": ("train", GLM, TRAIN["layers"], TRAIN["batch"],
                     TRAIN["seq"]),
    f"train {MAMBA}": ("train", MAMBA, TRAIN_MAMBA["layers"],
                       TRAIN_MAMBA["batch"], TRAIN_MAMBA["seq"]),
}
DRYRUN_PEAK_TOL = 0.10    # predicted peak within 10% of the card's
# the region phase: glm4-9b's sublayer at full width; the reference's pins
# for the explicit-TP sublayer (tests/md/test_dist_jit.py:77-126)
REGION = {"batch": 2, "seq": 1024, "iters": 10}
TP_FWD_TOL, TP_GRAD_TOL = 2e-4, 5e-4
# the hybrid phase: mesh (1, 1, 1); the parity cut (fp32, 2 layers) and
# the train cut (bf16, 8 layers, phase 8's shape); the reference's pins
# for the executor (tests/md/test_hybrid.py:85-90), and each grad leaf to
# PARITY_TOL of its largest |value|
HYBRID = {"micro": 4, "parity_layers": 2, "batch": 4, "seq": 1024}
# (dp, pp, cp, tp, ep) by card count: one NCCL rank per card, as phase 10
HYBRID_MESHES = {1: (1, 1, 1, 1, 1), 4: (1, 2, 1, 2, 1)}
HYBRID_LOSS_RTOL, HYBRID_GRAD_TOL = 2e-5, 5e-4
# the moe phase: jamba-v0.1-52b at its published widths, depth cut from 32
# to one 8-layer period; flash 1 (the attention layer's prefill), SSD 7
# (the SSM layers' prefill) and RMSNorm 24 a forward x 33 forwards
JAMBA, KIMI = "jamba-v0.1-52b", "kimi-k2-1t-a32b"
LLAMA4 = "llama4-maverick-400b-a17b"
MOE = {"layers": 8, "batch": 4, "prompt_len": 1024, "steps": 32,
       "parity_prompt": 64, "ffn_tokens": 512, "time_batch": 2,
       "time_seq": 1024, "time_iters": 5,
       "launches": {"flash_attention": 1, "rmsnorm": 792, "ssd_scan": 7}}
MOE_NORM_CASES = [(4, 4096), (4096, 4096),   # jamba's norms: decode, prefill
                  (4, 8192), (4096, 8192)]   # its gated norm over d_inner
MOE_AUX_RTOL = 1e-5
MOE_TRAIN_TOL = 1e-4   # tests/test_torch_train.py's pin
# tests/md/test_moe_md.py:125-150: the ep-grads config and its pins, at 4
# query heads over 2 of 16 (its 8 over 4 of 8 at the same width and GQA
# group: head dim 8 is not one the flash kernels take, HEAD_DIMS)
MOE_HYBRID_CFG = dict(name="ep-grads", family="moe", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                      d_ff=128, vocab_size=256, dtype="float32", remat=False,
                      attn_chunk=16, num_experts=4, experts_per_token=2,
                      moe_d_ff=96, moe_layer_period=2, moe_offset=1,
                      num_shared_experts=1, capacity_factor=4.0)
MOE_HYBRID_LOSS_RTOL, MOE_HYBRID_ATOL, MOE_HYBRID_RTOL = 1e-5, 1e-5, 2e-4
# (dp, pp, cp, tp, ep); the last two need 4 cards (NVLink all-to-all)
MOE_MESHES = {"single": (1, 1, 1, 1, 1), "ep4": (1, 1, 1, 1, 4),
              "ep2_tp2": (1, 1, 1, 2, 2)}


# the ring phase (13): glm4-9b's attention widths cut into cp = 4 virtual
# ranks of 1024 (chunk = attn_chunk), the reference's ring pins
# (tests/md/test_ring_attention.py:105-110) scaled by the output's magnitude;
# one hop timed at B 4, Sq = Skv = 1024; the 4-card meshes (dp, pp, cp, tp,
# ep), their fp32 parity cut and bf16 timing cut
RING = {"batch": 2, "seq": 4096, "cp": 4, "chunk": 512, "hop_batch": 4,
        "hop_seq": 1024, "iters": 5, "ctx_layers": 2, "ctx_batch": 2,
        "ctx_seq": 1024}
RING_FWD_TOL, RING_GRAD_RTOL, RING_GRAD_ATOL = 2e-5, 5e-4, 5e-5
RING_MESHES = {"cp4": (1, 1, 4, 1, 1), "cp2_tp2": (1, 1, 2, 2, 1)}
RING_PARITY = {"batch": 2, "seq": 2048, "micro": 2}   # 2 layers, fp32
RING_TRAIN = {"layers": 8, "batch": 4, "seq": 4096, "micro": 4, "steps": 5}
# kimi-k2-1t-a32b's attention (64 heads of 112 over 8 KV heads, d_model
# 7168): the head dim 112 kernels at its prefill shape, and its full-width
# attention sub-layer card (bf16) vs host (fp32)
KIMI_ATTN = {"batch": 1, "seq": 1024}
# Phase 14: (a) phase 8's cell, (b) the chaos heal at depth 2, (c) a
# one-rank fault's heal and the elastic shrink on 4 cards; checkpoints
# under the gitignored build/.
CKPT_ROOT = ROOT / "build" / "ckpt"
# The one-card machine takes at most 45 GiB of disk writes in one call,
# deleted files included: (a) writes 28.7 GB once, so (b) keeps glm4-9b's
# layer widths and depth 2 but cuts its vocabulary (embedding and LM head
# are 12.4 of its 16.5 GB) and runs the shortest course that falls back
# past a corrupt checkpoint: three saves of 4.75 GB.
RESIL = {"batch": 4, "seq": 1024, "layers_a": 8, "layers_b": 2,
         "vocab_b": 8192, "steps_b": 5,
         "plan": "poison=3,crash=4,corrupt=bitflip", "ckpt_every": 2,
         "keep": 2}
RESIL_MESH = {"full": (2, 1, 1, 2, 1), "plan": "shrink=3:data", "batch": 8,
              "micro": 2, "steps": 4, "ckpt_every": 2,
              # the heal: (b)'s config, an OSError in this rank's save of
              # this step (after its part of the save's collectives)
              "fault_rank": 3, "fault_step": 2}
# (a)'s checkpoint served through the CLI's --ckpt-dir: B, prompt, steps
RESIL_SERVE = {"batch": 4, "prompt_len": 64, "steps": 8}
# Phase 15: the stub frontends at their published widths (prefill from
# random embeds, then greedy decode from tokens), each also cut to 2
# layers for card-vs-host parity (B 2, S 200, 4 decode steps)
PIXTRAL, MUSICGEN = "pixtral-12b", "musicgen-medium"
FRONTENDS = {PIXTRAL: {"batch": 4, "prompt_len": 1024, "steps": 32},
             MUSICGEN: {"batch": 4, "prompt_len": 1024, "steps": 32}}
FRONTEND_PARITY = {"batch": 2, "prompt_len": 200, "steps": 4}
# Phase 16: sharded serving at full width on a (data, model) = (1, 1)
# mesh, one NCCL rank, against the engine with no policy on the same
# parameters (the path's code at world 1): glm4-9b (depth cut 40 -> 8, for
# the script's time) under each cache layout; jamba-v0.1-52b cut to one
# 8-layer period (its SSM mixers, MoE FFNs and attention; 32 layers do
# not fit one card) and mamba2-370m, all 48 layers, under kvdim (an SSM
# state's layout does not depend on it).  The 4-card cells
# (tools/serve_phase_torch.py --four-card-meshes), each at (1, 4):
# mistral-large-123b, (a) 2 layers against one card, fp32 and bf16, (b)
# all 88 layers from the per-rank initialiser; jamba-v0.1-52b, (a) one
# period against one card, fp32 and bf16, (b) all 32 layers from the
# per-rank initialiser; glm4-9b, all 40 layers (2 K/V heads under TP 4)
# against one card, bf16.
MISTRAL = "mistral-large-123b"
SHARDED = {GLM: {"layers": 8, "batch": 4, "prompt_len": 1024, "steps": 32,
                 "layouts": ("kvdim", "kvseq")},
           JAMBA: {"layers": 8, "batch": 4, "prompt_len": 1024, "steps": 32,
                   "layouts": ("kvdim",)},
           MAMBA: {"layers": 48, "batch": 8, "prompt_len": 2048,
                   "steps": 32, "layouts": ("kvdim",)}}
LAYOUTS = ("kvdim", "kvseq")
SERVE_MESH = (1, 4)
# cell -> (arch, the parity cut's layers or None, the full run's layers,
# whether the full run draws this rank's shards alone, as a model no card
# holds whole must, or cuts them from the global tree held against one
# card)
SERVE_MESH_CELLS = {"mistral": (MISTRAL, 2, 88, True),
                    "jamba": (JAMBA, 8, 32, True),
                    "glm4": (GLM, None, 40, False)}
SERVE_MESH_PARITY = {"batch": 4, "prompt_len": 256, "steps": 8}
SERVE_MESH_FULL = {"batch": 4, "prompt_len": 1024, "steps": 32}


def expect_routes(name, dtype, before):
    """``name`` was launched once since ``before`` and by ``dtype``'s route."""
    got = {r: ops.ROUTE_LAUNCHES[name][r] - before[r] for r in before}
    want = {r: int(r == ROUTES[dtype]) for r in before}
    if got != want:
        raise AssertionError(f"{name} {dtype}: routes {got}, expected {want}")


def emit(**row):
    print(json.dumps(row), flush=True)


peaks = roofline.peaks


def card_bound(cost, dtype, route=""):
    """``roofline.bound`` of a ``kernel_cost`` on this card's peaks (a
    kernel's at its ``route``'s rate: ``tf32x3``'s three TF32 passes)."""
    return roofline.bound(cost, dtype, peaks(torch.cuda.get_device_name(0))[1],
                          route)


def cuda_ms(fn, iters=20):
    """Mean device milliseconds of one call of ``fn``: ``iters`` calls are
    captured in one CUDA graph and replayed between two CUDA events, so the
    host's cost of launching them is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up (compile, allocate) uncaptured
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, want, tol):
    """|got - want| <= tol + tol |want| everywhere; returns the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = int((err > tol + tol * want.abs()).sum())
    emit(phase="check", case=name, max_abs_err=float(err.max()), tol=tol,
         mismatches=bad)
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {bad} elements outside tolerance {tol}")
    return float(err.max())


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no card",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    table, _ = peaks(name)
    emit(phase="device", kind=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         peaks=table)
    return smi


def phase_build():
    t0 = time.perf_counter()
    libs = build.build()
    secs = time.perf_counter() - t0
    for name, path in libs.items():
        log = path.with_suffix(".log").read_text().strip().splitlines()
        emit(phase="build", lib=name, seconds=secs,
             ptxas=[ln for ln in log if "registers" in ln or "spill" in ln])


def ssd_inputs(B, S, H, P, N, dtype, gen, model=False):
    """x, dt, a_neg, Bm, Cm as the reference's sweep draws them, or, with
    ``model``, dt and A as mamba2's block makes them: dt the softplus of a
    unit-scale projection, A = exp(a_log) with a_log ~ U[0, log 16)."""
    if model:
        dt = F.softplus(randn((B, S, H), torch.float32, gen))
        a_neg = -torch.exp(torch.rand((H,), generator=gen, device="cuda")
                           * math.log(16.0))
    else:
        dt = F.softplus(randn((B, S, H), torch.float32, gen)) * 0.1
        a_neg = -torch.exp(randn((H,), torch.float32, gen) * 0.2)
    return (randn((B, S, H, P), dtype, gen), dt, a_neg,
            randn((B, S, N), dtype, gen), randn((B, S, N), dtype, gen))


def phase_kernels():
    """Hold the kernels against their plain versions; time them at their
    serving shapes.  Returns the kernels' rows (launches filled in later)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    H, KH, hd = 32, 2, 128
    for B, S in ((2, 512), (1, 2048), (2, 200)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q = randn((B, S, H, hd), dtype, gen)
                k = randn((B, S, KH, hd), dtype, gen)
                v = randn((B, S, KH, hd), dtype, gen)
                before = dict(ops.ROUTE_LAUNCHES["flash_attention"])
                got = ops.flash_attention(q, k, v, causal=causal)
                expect_routes("flash_attention", dtype, before)
                want = ref.attention_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                check_close(f"flash B={B} S={S} {dtype} causal={causal}",
                            got, want, FLASH_TOL[dtype])
    for rows, d in NORM_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((rows, d), dtype, gen)
            w = 1.0 + 0.1 * randn((d,), torch.float32, gen)
            got = ops.rmsnorm(x, w)
            want = ref.rmsnorm_ref(x, w)
            torch.cuda.synchronize()
            check_close(f"rmsnorm rows={rows} d={d} {dtype}", got, want,
                        NORM_TOL[dtype])
    for B, S, H, P, N, chunk in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(B, S, H, P, N, dtype, gen)
            before = dict(ops.ROUTE_LAUNCHES["ssd_scan"])
            y, h = ops.ssd_scan(*args, chunk=chunk)
            expect_routes("ssd_scan", dtype, before)
            case = f"ssd B={B} S={S} H={H} P={P} N={N} L={chunk} {dtype}"
            for plain, (want_y, want_h) in (
                    ("ssd_ref", ref.ssd_ref(*args)),
                    ("ssd_chunked", ref.ssd_chunked(*args, chunk=chunk))):
                torch.cuda.synchronize()
                check_close(f"{case} y vs {plain}", y, want_y, SSD_TOL[dtype])
                check_close(f"{case} h_final vs {plain}", h, want_h,
                            SSD_TOL[dtype])
    phase_tensor_core_checks(gen)
    phase_empty_blocks(gen)
    phase_head_dim_112(gen)
    return phase_timing(gen)


def phase_empty_blocks(gen):
    """A rank holding no head (a model axis larger than the head count):
    flash with H = KH = 0 and the SSD scan with H = 0, each dtype, return
    the plain versions' (empty) shapes and launch nothing."""
    for dtype in (torch.float32, torch.bfloat16):
        q = randn((2, 64, 0, 128), dtype, gen)
        x, dt, a_neg, bm, cm = ssd_inputs(2, 64, 0, 64, 128, dtype, gen)
        before = snapshot()
        o = ops.flash_attention(q, q, q)
        y, h = ops.ssd_scan(x, dt, a_neg, bm, cm)
        torch.cuda.synchronize()
        got = [tuple(t.shape) for t in (o, y, h)]
        want = [tuple(ref.attention_ref(q, q, q).shape)] + [
            tuple(t.shape) for t in ref.ssd_chunked(x, dt, a_neg, bm, cm,
                                                    chunk=64)]
        emit(phase="check", case=f"empty head blocks {dtype}", shapes=got,
             launches=snapshot() == before)
        if got != want or snapshot() != before:
            raise AssertionError(f"empty head blocks {dtype}: shapes {got} "
                                 f"(plain {want}), launches "
                                 f"{snapshot()} after {before}")


def phase_head_dim_112(gen):
    """Head dim 112 (kimi-k2-1t-a32b: 64 heads of 112 over 8 KV heads) on
    both routes against the plain version at kimi's prefill shape, causal,
    at the pins; each timed beside the plain version and SDPA, with its
    bound (the bf16 kernel's P V product runs the 128 columns it lays the
    head out at, 16 more than the bound counts)."""
    cfg = get_config(KIMI)
    B, S = KIMI_ATTN["batch"], KIMI_ATTN["seq"]
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (randn((B, S, n, hd), dtype, gen) for n in (H, KH, KH))
        before = dict(ops.ROUTE_LAUNCHES["flash_attention"])
        got = ops.flash_attention(q, k, v)
        expect_routes("flash_attention", dtype, before)
        torch.cuda.synchronize()
        err = check_close(f"flash hd=112 {KIMI} q ({B},{S},{H},{hd}) "
                          f"{dtype} causal", got, ref.attention_ref(q, k, v),
                          FLASH_TOL[dtype])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bound = card_bound(kernel_cost(
            "flash_attention", q.shape, k.shape, v.shape, dtype=dtype), dtype,
            ROUTES[dtype])
        emit(phase="timing_hd112", arch=KIMI, route=ROUTES[dtype],
             dtype=str(dtype), shape=f"q ({B},{S},{H},{hd}) k/v "
             f"({B},{S},{KH},{hd}) causal", max_abs_err=err,
             ms=cuda_ms(lambda: ops.flash_attention(q, k, v)),
             plain_ms=cuda_ms(lambda: ref.attention_ref(q, k, v), iters=5),
             library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True)),
             bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])


def phase_tensor_core_checks(gen):
    """Both tensor-core routes, bf16 and fp32 (3xTF32), at every head dim
    (flash) and every head dim and chunk tile (SSD); each on strided views,
    the bf16 routes refusing a stride they cannot address and the fp32
    ones reading unaligned strides 4 bytes at a time.  SSD h_final is held
    at the fp32 pin: both sides form it in fp32 from the same inputs."""
    bf16 = torch.bfloat16
    for dtype in (bf16, torch.float32):
        tag = "tc" if dtype == bf16 else "tf32x3"
        for hd in HEAD_DIMS:
            for B, Sq, Skv, H, KH in FLASH_TC_CASES:
                for causal in (True, False):
                    if causal and Sq != Skv:
                        continue
                    q = randn((B, Sq, H, hd), dtype, gen)
                    k = randn((B, Skv, KH, hd), dtype, gen)
                    v = randn((B, Skv, KH, hd), dtype, gen)
                    before = dict(ops.ROUTE_LAUNCHES["flash_attention"])
                    got = ops.flash_attention(q, k, v, causal=causal)
                    expect_routes("flash_attention", dtype, before)
                    torch.cuda.synchronize()
                    check_close(f"flash {tag} hd={hd} B={B} Sq={Sq} "
                                f"Skv={Skv} H={H} KH={KH} causal={causal}",
                                got, ref.attention_ref(q, k, v,
                                                       causal=causal),
                                FLASH_TOL[dtype])
        for P, tile, S in SSD_TC_CASES:
            args = ssd_inputs(2, S, 8, P, 128, dtype, gen)
            before = dict(ops.ROUTE_LAUNCHES["ssd_scan"])
            y, h = ops.ssd_scan(*args, chunk=tile)
            expect_routes("ssd_scan", dtype, before)
            case = f"ssd {tag} B=2 S={S} H=8 P={P} N=128 L={tile}"
            for plain, (want_y, want_h) in (
                    ("ssd_ref", ref.ssd_ref(*args)),
                    ("ssd_chunked", ref.ssd_chunked(*args, chunk=tile))):
                torch.cuda.synchronize()
                check_close(f"{case} y vs {plain}", y, want_y, SSD_TOL[dtype])
                check_close(f"{case} h_final vs {plain}", h, want_h,
                            SSD_TOL[torch.float32])
    f32 = torch.float32
    buf = randn((1, 64, 4 * 64 + 3), f32, gen)   # base and steps unaligned
    q = buf[:, :, 1:257].unflatten(2, (4, 64))
    check_close("flash tf32x3 unaligned strides", ops.flash_attention(q, q, q),
                ref.attention_ref(q, q, q), FLASH_TOL[f32])
    x, dt, a_neg, _, _ = ssd_inputs(1, 64, 2, 16, 16, f32, gen)
    bc = randn((1, 64, 21), f32, gen)
    args = (x, dt, a_neg, bc[:, :, 1:17], bc[:, :, 2:18])
    y, h = ops.ssd_scan(*args, chunk=32)
    want_y, want_h = ref.ssd_ref(*args)
    check_close("ssd tf32x3 unaligned B/C y", y, want_y, SSD_TOL[f32])
    check_close("ssd tf32x3 unaligned B/C h_final", h, want_h, SSD_TOL[f32])
    qkv = randn((2, 96, 12, 64), bf16, gen)   # q, k, v sliced from one tensor
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    check_close("flash tc strided q/k/v", ops.flash_attention(q, k, v),
                ref.attention_ref(q, k, v), FLASH_TOL[bf16])
    buf = randn((1, 64, 4 * 64 + 4), bf16, gen)
    refuse("flash tc step stride 260", lambda: ops.flash_attention(
        *[buf.as_strided((1, 64, 4, 64), (64 * 260, 260, 64, 1))] * 3))

    xz = randn((2, 96, 8, 32), bf16, gen)     # x, B, C sliced, dt strided
    bc = randn((2, 96, 64), bf16, gen)
    _, dt2, a_neg, _, _ = ssd_inputs(2, 96, 8, 32, 32, bf16, gen)
    args = (xz[:, :, 4:], dt2[:, :, ::2], a_neg[:4], bc[:, :, :32],
            bc[:, :, 32:])
    y, h = ops.ssd_scan(*args, chunk=32)
    want_y, want_h = ref.ssd_ref(*args)
    check_close("ssd tc strided y", y, want_y, SSD_TOL[bf16])
    check_close("ssd tc strided h_final", h, want_h, SSD_TOL[torch.float32])
    x, dt, a_neg, bm, cm = ssd_inputs(1, 64, 2, 16, 16, bf16, gen)
    refuse("ssd tc B stride 20", lambda: ops.ssd_scan(
        x, dt, a_neg, randn((1, 64, 20), bf16, gen)[:, :, :16], cm))


def refuse(case, fn):
    """``fn`` must raise ValueError (and launch nothing)."""
    before = {k: dict(v) for k, v in ops.ROUTE_LAUNCHES.items()}
    try:
        fn()
    except ValueError as e:
        if ops.ROUTE_LAUNCHES != before:
            raise AssertionError(f"{case}: launched before refusing") from e
        emit(phase="check", case=case, refused=str(e))
        return
    raise AssertionError(f"{case}: accepted, should raise ValueError")


def timing_row(name, route, impl, dtype, cores, source, replaces, tpu, shape,
               err, fn, plain, library, cost, iters=20):
    """``cost``: the call's ``kernel_cost``, priced at ``dtype``'s peak on
    the ``impl`` route (``tf32x3``: three TF32 passes); an fp32 row also
    gets the bound on the fp32 CUDA cores (``fp32_cores_bound_ms``)."""
    nbytes, work = cost["bytes"], cost["flops"]
    row = {"name": name, "route": route, "impl": impl, "dtype": str(dtype),
           "cores": cores, "source": source, "replaces": replaces, "tpu": tpu,
           "shape": shape, "max_abs_err": err,
           "ms": cuda_ms(fn, iters=iters),
           "plain_ms": cuda_ms(plain, iters=max(3, iters // 4)),
           "library_ms": None if library is None else cuda_ms(library,
                                                              iters=iters),
           "bytes": nbytes, "flops": work,
           "fp32_cores_bound_ms": (card_bound(cost, dtype)["bound_ms"]
                                   if dtype == torch.float32 else None)}
    row.update(card_bound(cost, dtype, impl))
    row["tflops"] = work / row["ms"] / 1e9
    row["gbps"] = nbytes / row["ms"] / 1e6
    emit(phase="timing", **row)
    return row


def phase_timing(gen):
    """Each kernel's, per route, its plain version's and a library call's
    times at its serving shape (the bf16 rows are the serving route; the
    fp32 rows time the 3xTF32 kernels at the same shapes, bound by three
    TF32 passes and, beside it, by the fp32 CUDA cores)."""
    bf16 = torch.bfloat16
    rows = []
    B, S, H, KH, hd = 4, 1024, 32, 2, 128
    for dtype in (bf16, torch.float32):
        q, k, v = (randn((B, S, n, hd), dtype, gen) for n in (H, KH, KH))
        err = check_close(f"flash serving shape {dtype}",
                          ops.flash_attention(q, k, v),
                          ref.attention_ref(q, k, v), FLASH_TOL[dtype])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        size = dtype.itemsize
        tc = dtype == bf16
        rows.append(timing_row(
            "flash_attention" if tc else "flash_attention_fp32", "cuda",
            ROUTES[dtype], dtype,
            "tensor (wgmma)" if tc else "tensor (mma.sync, 3xTF32)",
            "src/repro_torch/kernels/csrc/flash_attention"
            + ("_tc.cu" if tc else ".cu"),
            "src/repro/kernels/flash_attention.py:69",
            "kernels/flash_attention.py::flash_attention_fwd",
            f"q ({B},{S},{H},{hd}) k/v ({B},{S},{KH},{hd}) {dtype} causal",
            err, lambda: ops.flash_attention(q, k, v),
            lambda: ref.attention_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            kernel_cost("flash_attention", q.shape, k.shape, v.shape,
                        dtype=dtype)))

    d = 4096   # the norm timed at glm4-9b's prefill
    x = randn((B * S, d), bf16, gen)
    w = 1.0 + 0.1 * randn((d,), torch.float32, gen)
    w_lib = w.to(bf16)   # F.rms_norm takes its weight in x's dtype
    err = check_close("rmsnorm serving shape", ops.rmsnorm(x, w),
                      ref.rmsnorm_ref(x, w), NORM_TOL[bf16])
    rows.append(timing_row(
        "rmsnorm", "triton", "triton", bf16, "CUDA cores",
        "src/repro_torch/kernels/rmsnorm.py",
        "src/repro/kernels/rmsnorm.py:24", "kernels/rmsnorm.py::rmsnorm_fwd",
        f"x ({B * S},{d}) bf16, w ({d},) fp32", err,
        lambda: ops.rmsnorm(x, w), lambda: ref.rmsnorm_ref(x, w),
        lambda: F.rms_norm(x, (d,), w_lib, 1e-6),
        kernel_cost("rmsnorm", x.shape, w.shape, dtype=bf16,
                    w_dtype=w.dtype), iters=100))

    # the SSD scan at mamba2-370m's prefill of the serve phase: bf16 with dt
    # and A drawn as the block makes them; fp32 at the sweep's draws, where
    # the fp32 pin holds between two chunked forms (PERF.md)
    B, S, H, P, N, L = 8, 2048, 32, 64, 128, 64
    for dtype in (bf16, torch.float32):
        tc = dtype == bf16
        args = ssd_inputs(B, S, H, P, N, dtype, gen, model=tc)
        y, h = ops.ssd_scan(*args, chunk=L)
        want_y, want_h = ref.ssd_chunked(*args, chunk=L)
        err = check_close(f"ssd serving shape y {dtype}", y, want_y,
                          SSD_TOL[dtype])
        # both sides form the state in fp32 from the same inputs
        err = max(err, check_close(f"ssd serving shape h_final {dtype}", h,
                                   want_h, SSD_TOL[torch.float32]))
        rows.append(timing_row(
            "ssd_scan" if tc else "ssd_scan_fp32", "cuda", ROUTES[dtype],
            dtype, "tensor (mma.sync)" if tc else "tensor (mma.sync, 3xTF32)",
            "src/repro_torch/kernels/csrc/ssd_scan"
            + ("_tc.cu" if tc else ".cu"),
            "src/repro/kernels/ssd_scan.py:60",
            "kernels/ssd_scan.py::ssd_scan_fwd",
            f"x ({B},{S},{H},{P}) B/C ({B},{S},{N}) {dtype}, dt fp32, "
            f"chunk {L}", err,
            lambda: ops.ssd_scan(*args, chunk=L),
            lambda: ref.ssd_chunked(*args, chunk=L),
            None,   # no one PyTorch call computes the SSD scan
            kernel_cost("ssd_scan", *(t.shape for t in args),
                        dtype=dtype, chunk=L), iters=10))
    # the bf16 SSD kernel at half and twice the serving batch: 128, 256 and
    # 512 blocks (one block per (batch, head)) on 132 SMs, two a SM
    for Bb in (4, 8, 16):
        args = ssd_inputs(Bb, S, H, P, N, bf16, gen, model=True)
        emit(phase="ssd_blocks", batch=Bb, blocks=Bb * H,
             ms=cuda_ms(lambda: ops.ssd_scan(*args, chunk=L), iters=10))
    return rows


def snapshot():
    """The launch counts, by kernel and by route."""
    return {"launches": dict(ops.LAUNCHES),
            "routes": {k: dict(v) for k, v in ops.ROUTE_LAUNCHES.items()}}


def expect_no_route(arch, snap, route):
    """No launch of ``route`` in ``snap`` (the other dtype's path)."""
    used = {k: v[route] for k, v in snap["routes"].items() if v[route]}
    if used:
        raise AssertionError(f"{arch}: {route} kernels launched: {used}")


def phase_parity(arch):
    """fp32 ``arch`` at full width, 2 layers: card (3xTF32 kernels) vs
    host (plain).  Returns the launch counts of the card's run."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype="float32")
    B, S, steps = 2, 200, 8
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(cfg, gen, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    ops.reset_launches()
    gpu = ServeEngine(cfg, params, max_seq=S + steps + 8, batch_size=B)
    cpu = ServeEngine(cfg, {k: t.cpu() for k, t in params.items()},
                      max_seq=S + steps + 8, batch_size=B)
    logits_g, cache_g = gpu.prefill(prompt)
    logits_c, cache_c = cpu.prefill(prompt.cpu())
    check_close(f"parity {arch} prefill logits", logits_g.cpu(), logits_c,
                PARITY_TOL)
    for name in cache_c:
        check_close(f"parity {arch} cache {name}", cache_g[name].cpu(),
                    cache_c[name], PARITY_TOL)
    tok_g = gpu.generate(prompt, steps).cpu()
    tok_c = cpu.generate(prompt.cpu(), steps)
    same = bool(torch.equal(tok_g, tok_c))
    snap = snapshot()
    emit(phase="parity", arch=arch, greedy_tokens_equal=same, steps=steps,
         tokens=tok_g[0].tolist(), launches=snap)
    if not same:
        raise AssertionError(f"{arch}: greedy tokens differ: card "
                             f"{tok_g.tolist()} host {tok_c.tolist()}")
    expect_no_route(arch, snap, "tensor_core")
    return snap


def check_scaled(name, got, want, tol):
    """max |got - want| <= tol * max |want|; returns the error's share of
    the scale."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    share = err / max(scale, 1e-30)
    emit(phase="check", case=name, max_abs_err=err, scale=scale,
         share=share, tol=tol)
    if share > tol or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: error {err} is {share:.4f} of the "
                             f"scale {scale}, above {tol}")
    return share


def phase_parity_bf16(arch):
    """bf16 ``arch`` at full width, 2 layers, on the card (tensor-core
    kernels) against the host's fp32 forward from the same bf16-rounded
    parameters: prefill logits and caches within BF16_PARITY_TOL of their
    scale, and the same first greedy token in every row.  Returns the launch
    counts of the card's run."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="bfloat16")
    B, S = 2, 200
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = init_params(cfg, gen, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    ops.reset_launches()
    gpu = ServeEngine(cfg, params, max_seq=S + 8, batch_size=B)
    logits_g, cache_g = gpu.prefill(prompt)
    torch.cuda.synchronize()
    snap = snapshot()
    cpu = ServeEngine(dataclasses.replace(cfg, dtype="float32"),
                      {k: t.float().cpu() for k, t in params.items()},
                      max_seq=S + 8, batch_size=B)
    logits_c, cache_c = cpu.prefill(prompt.cpu())
    check_scaled(f"parity bf16 {arch} prefill logits", logits_g.cpu(),
                 logits_c, BF16_PARITY_TOL)
    for name in cache_c:
        check_scaled(f"parity bf16 {arch} cache {name}", cache_g[name].cpu(),
                     cache_c[name], BF16_PARITY_TOL)
    tok_g = logits_g.float().argmax(-1).cpu()
    tok_c = logits_c.argmax(-1)
    top2 = torch.topk(logits_c, 2, dim=-1).values
    emit(phase="parity_bf16", arch=arch, first_token_card=tok_g.tolist(),
         first_token_host=tok_c.tolist(),
         host_top2_margin=(top2[:, 0] - top2[:, 1]).tolist(), launches=snap)
    if not torch.equal(tok_g, tok_c):
        raise AssertionError(f"{arch}: first greedy tokens differ: card "
                             f"{tok_g.tolist()} host {tok_c.tolist()}")
    expect_no_route(arch, snap, "tf32x3")
    return snap


def expected_launches(cfg, steps):
    """Launches of one request (prefill + ``steps`` decode steps): flash
    and the SSD scan once per layer of their kind in prefill; the norm
    before each mixer and FFN, inside each SSM mixer and at the end, in
    every forward."""
    kinds = [(cfg.mixer_kind(i), cfg.ffn_kind(i))
             for i in range(cfg.num_layers)]
    norms = 1 + sum(1 + (ffn != "none") + (mixer == "ssm")
                    for mixer, ffn in kinds)
    return {"flash_attention": sum(m == "attn" for m, _ in kinds),
            "rmsnorm": norms * (1 + steps),
            "ssd_scan": sum(m == "ssm" for m, _ in kinds)}


def phase_serve(arch, smi):
    """The full bf16 model through the CLI's main(): a warm-up run, then
    the measured run with the launch counts read around it."""
    cfg = get_config(arch)
    run = SERVE[arch]
    argv = ["--arch", arch, "--batch", str(run["batch"]),
            "--prompt-len", str(run["prompt_len"])]
    serve.main(argv + ["--steps", "2"])           # warm-up: 2 decode steps
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = serve.main(argv + ["--steps", str(run["steps"])])
    snap = snapshot()
    launches = snap["launches"]
    peak = torch.cuda.max_memory_allocated()
    tokens = res["tokens"]
    emit(phase="serve", arch=arch, layers=cfg.num_layers, dtype="bfloat16",
         **run, prefill_s=res["prefill_s"], decode_s=res["decode_s"],
         prefill_tok_s=res["prefill_tok_s"], decode_tok_s=res["decode_tok_s"],
         peak_mem_bytes=peak, launches=launches, routes=snap["routes"],
         nvidia_smi=smi)
    if not res["logits_finite"]:
        raise AssertionError(f"{arch}: non-finite logits")
    if tokens.shape != (run["batch"], run["steps"]) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"{arch}: tokens out of range: "
                             f"{tokens.tolist()}")
    want = expected_launches(cfg, run["steps"])
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches}, expected {want}")
    for name in ("flash_attention", "ssd_scan"):   # bf16: the tensor cores
        routes = {"tensor_core": want[name], "tf32x3": 0}
        if snap["routes"][name] != routes:
            raise AssertionError(f"{arch}: {name} routes "
                                 f"{snap['routes'][name]}, expected {routes}")
    return snap


def phase_decode_share(arch, smi):
    """One bf16 decode step of the full model, run eagerly (host clock,
    synchronised) and replayed from a CUDA graph (device time only): the
    device's busy share of an eager step is their ratio."""
    cfg = get_config(arch)
    B, S = SERVE[arch]["batch"], SERVE[arch]["prompt_len"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    engine = ServeEngine(cfg, init_params(cfg, gen, "cuda"), max_seq=S + 8,
                         batch_size=B)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    emit(phase="decode_share", arch=arch, **decode_busy(engine, prompt),
         nvidia_smi=smi)


def decode_busy(engine, prompt):
    """One decode step after ``prompt``'s prefill, run eagerly (host
    clock, synchronised) and replayed from a CUDA graph (device time
    only), and the device's busy share of the eager step."""
    B, S = prompt.shape
    _, cache = engine.prefill(prompt)
    tok = prompt[:, -1:]

    def step():
        return engine.decode_step(cache, tok, S)

    iters = 10
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / iters
    device_ms = cuda_ms(step, iters=iters)
    return {"batch": B, "cache_len": S, "eager_step_ms": eager_ms,
            "device_step_ms": device_ms,
            "device_busy_share": device_ms / eager_ms}


def event_ms(fn, iters):
    """Mean milliseconds of ``fn`` over ``iters`` eager calls, between two
    CUDA events on the current stream (after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def backward_row(name, kernel, plain, inputs, tol, iters):
    """Grads of every input for one random cotangent per output, through
    ``kernel`` (ops: the kernel forward, the recompute backward) and through
    ``plain``'s own autograd; returns (max abs error, backward ms)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    xs = [t.detach().requires_grad_() for t in inputs]
    outs = kernel(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    if any(o.grad_fn is None for o in outs):
        raise AssertionError(f"backward {name}: ops output carries no grad")
    cots = [torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
            for o in outs]
    got = torch.autograd.grad(outs, xs, cots, retain_graph=True)
    want_outs = plain(*xs)
    want_outs = want_outs if isinstance(want_outs, tuple) else (want_outs,)
    want = torch.autograd.grad(want_outs, xs, cots)
    torch.cuda.synchronize()
    err = max(check_close(f"backward {name} d{i}", g, w, tol)
              for i, (g, w) in enumerate(zip(got, want)))
    ms = event_ms(lambda: torch.autograd.grad(outs, xs, cots,
                                              retain_graph=True), iters)
    emit(phase="backward", name=name, backward=BACKWARD, max_abs_err=err,
         backward_ms=ms, shapes=[list(t.shape) for t in xs])
    return err, ms


def phase_backward(rows):
    """Each kernel's backward at its serving shape (PERF.md): flash q
    (4,1024,32,128) bf16 and fp32, RMSNorm (4096,4096) bf16 with w fp32,
    SSD x (8,2048,32,64) bf16 and fp32 at mamba2's dt and A draws.  Adds
    ``backward`` and ``backward_ms`` to each kernel's row."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16, fp32 = torch.bfloat16, torch.float32
    out = {}
    B, S, H, KH, hd = 4, 1024, 32, 2, 128
    for dtype, name in ((bf16, "flash_attention"),
                        (fp32, "flash_attention_fp32")):
        qkv = [randn((B, S, n, hd), dtype, gen) for n in (H, KH, KH)]
        out[name] = backward_row(
            name, ops.flash_attention,
            lambda q, k, v: ref.blockwise_attention(
                q, k, v, chunk=min(512, k.shape[1]), causal=True),
            qkv, FLASH_TOL[dtype], iters=5)
    x = randn((B * S, 4096), bf16, gen)
    w = 1.0 + 0.1 * randn((4096,), fp32, gen)
    out["rmsnorm"] = backward_row("rmsnorm", ops.rmsnorm, ref.rmsnorm_ref,
                                  (x, w), NORM_TOL[bf16], iters=20)
    B, S, H, P, N, L = 8, 2048, 32, 64, 128, 64
    for dtype, name in ((bf16, "ssd_scan"), (fp32, "ssd_scan_fp32")):
        args = ssd_inputs(B, S, H, P, N, dtype, gen, model=True)
        out[name] = backward_row(
            name, lambda *a: ops.ssd_scan(*a, chunk=L),
            lambda *a: ref.ssd_chunked(*a, chunk=L), args, SSD_TOL[dtype],
            iters=3)
    for row in rows:
        row["backward"] = BACKWARD
        row["backward_max_abs_err"], row["backward_ms"] = out[row["name"]]


def phase_train_parity():
    """fp32 glm4-9b at full width, 2 layers, batch 2, seq 200: the loss and
    every grad leaf on the card (3xTF32 kernels) against the host, then
    one AdamW step of the card's train step against the host's update of
    each leaf (to the pin, or where the clipped gradient is near Adam's eps
    to the bound its measured difference allows).  The host holds the fp32
    params and grads (~13 GB, and the card's grads copied back, ~6.6 GB)
    and takes its optimizer step one leaf at a time, so its moments exist
    for one leaf at a time.  Returns the launch counts of the card's run."""
    cfg = dataclasses.replace(get_config(GLM), num_layers=2, dtype="float32")
    B, S = 2, 200
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(4),
                         "cuda")
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=0)).batch(0)
    loss_fn = build_loss_fn(cfg)
    opt = make_optimizer(cfg.optimizer, total_steps=TRAIN["steps"],
                         base_lr=TRAIN["lr"])
    ops.reset_launches()
    loss_g, _, grads_g = loss_and_grads(loss_fn, params,
                                        batch_to_device(batch, "cuda"))
    host = {k: t.cpu() for k, t in params.items()}
    loss_c, _, grads_c = loss_and_grads(loss_fn, host,
                                        batch_to_device(batch, "cpu"))
    check_close("train parity loss", loss_g.cpu(), loss_c, PARITY_TOL)
    for name in sorted(grads_c):
        check_scaled(f"train parity grad {name}", grads_g[name].cpu(),
                     grads_c[name], PARITY_TOL)
    grads_g = {k: g.cpu() for k, g in grads_g.items()}
    state, met = build_train_step(cfg, opt)(
        init_train_state(cfg, params, opt), batch)
    torch.cuda.synchronize()
    snap = snapshot()
    gnorm = global_norm(grads_c)
    check_close("train parity grad_norm", met["grad_norm"].cpu(), gnorm,
                PARITY_TOL)
    scale_c = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12), max=1.0)
    scale_g = torch.clamp(1.0 / torch.clamp(met["grad_norm"].cpu(),
                                            min=1e-12), max=1.0)
    lr = opt.lr(1)
    near_eps = 0
    for name in sorted(host):
        old = host[name].clone()
        opt.update({name: grads_c[name]},
                   {"m": {name: torch.zeros_like(old)},
                    "v": {name: torch.zeros_like(old)}, "count": 0},
                   {name: host[name]}, scale=scale_c)
        # The step in units of lr.  Adam's first step is u = g/(|g| + eps)
        # (+ the same weight decay on both sides) for the clipped gradient
        # g: a sign function where |g| >> eps, but near eps a gradient
        # difference d moves u by up to d eps / (min |g| + eps)^2 (the mean
        # value bound; min |g| = 0 across a sign change).  So u is held to
        # the fp32 pin plus that bound of the measured gradient difference:
        # the pin alone wherever |g| >> eps.
        u_card = (state["params"][name].cpu() - old) / lr
        u_host = (host[name] - old) / lr
        err = (u_card - u_host).abs()
        pin = PARITY_TOL + PARITY_TOL * u_host.abs()
        a, b = grads_c[name] * scale_c, grads_g[name] * scale_g
        lo = torch.where(torch.sign(a) == torch.sign(b),
                         torch.minimum(a.abs(), b.abs()), 0.0)
        bound = pin + (a - b).abs() * opt.eps / (lo + opt.eps) ** 2
        miss = err > pin
        unexplained = int((err > bound).sum())
        near_eps += int(miss.sum())
        emit(phase="check", case=f"train parity AdamW step {name}",
             max_abs_err=float(err.max()), tol=PARITY_TOL,
             beyond_pin=int(miss.sum()), beyond_bound=unexplained,
             max_abs_clipped_grad_beyond_pin=float(a[miss].abs().max())
             if bool(miss.any()) else 0.0)
        if unexplained or not torch.isfinite(u_card).all():
            raise AssertionError(f"train parity {name}: {unexplained} "
                                 f"elements of the AdamW step off the pin "
                                 f"and the gradient's bound")
    emit(phase="train_parity", arch=GLM, layers=2, batch=B, seq=S,
         loss_card=float(loss_g), loss_host=float(loss_c),
         grad_norm=float(gnorm), lr=lr, adam_eps=opt.eps,
         steps_beyond_pin_near_eps=near_eps,
         launches=snap)
    expect_no_route("train parity", snap, "tensor_core")
    want = {"flash_attention": 2 * 2, "rmsnorm": 2 * 5, "ssd_scan": 0}
    if snap["launches"] != want:
        raise AssertionError(f"train parity: launches {snap['launches']}, "
                             f"expected {want}")
    return snap


def step_split(cfg, state, batch, opt):
    """One more train step, split by CUDA events into forward (to the
    loss), backward (autograd through the recompute backwards) and the
    optimizer (global norm, guard flag, AdamW in place)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    params = state["params"]
    batch = batch_to_device(batch, "cuda")
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    torch.cuda.synchronize()
    ev[0].record()
    loss, _ = build_loss_fn(cfg)(leaves, batch)
    ev[1].record()
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    ev[2].record()
    gnorm = global_norm(grads)
    if int(nonfinite_flag((loss, grads))):
        raise AssertionError("train split step: non-finite gradients")
    opt.update(grads, state["opt"], params,
               scale=torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12),
                                 max=1.0))
    ev[3].record()
    ev[3].synchronize()
    return {part: ev[i].elapsed_time(ev[i + 1]) for i, part in
            enumerate(("forward_ms", "backward_ms", "optimizer_ms"))}


def card_step(cfg, state, opt, B, S, base):
    """One more train step of ``build_train_step`` (``launch.train.train``'s
    step) on the card from ``state``, the card's side of a phase-18 cell:
    its ms (synchronised), launch counts and peak bytes above ``base``
    (allocated before the cell's state existed)."""
    step = build_train_step(dataclasses.replace(cfg, grad_accum=1), opt)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=1)).batch(0)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    _, met = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if met["skipped"]:
        raise AssertionError("card step: skipped")
    return {"ms": ms, "peak_bytes": torch.cuda.max_memory_allocated() - base,
            **snapshot()}


def phase_train(smi, arch=GLM):
    """bf16 ``arch`` at full width (glm4-9b cut to 8 layers; mamba2-370m
    at all 48) through launch/train.train: 5 AdamW steps with the launch
    counts read around them; then one step split by CUDA events and one
    measured for phase 18.  Returns (launch snapshot, that step)."""
    run = TRAINS[arch]
    base_cfg = get_config(arch)
    cfg = dataclasses.replace(base_cfg, num_layers=run["layers"])
    B, S, steps = run["batch"], run["seq"], run["steps"]
    logs = []
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state, hist = launch_train.train(cfg, steps=steps, batch=B, seq=S,
                                     lr=run["lr"], seed=0, device="cuda",
                                     logger=logs.append)
    snap = snapshot()
    peak = torch.cuda.max_memory_allocated()
    n = sum(p.numel() for p in state["params"].values())
    for rec in hist:
        emit(phase="train_step", arch=arch, step=rec["step"],
             loss=rec["loss"], grad_norm=rec["grad_norm"],
             skipped=rec["skipped"], step_ms=rec["sec"] * 1e3)
    secs = sorted(rec["sec"] for rec in hist[1:])
    median_s = (secs[(len(secs) - 1) // 2] + secs[len(secs) // 2]) / 2
    opt = make_optimizer(cfg.optimizer, total_steps=steps,
                         base_lr=run["lr"])
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=0)).batch(steps)
    split = step_split(cfg, state, batch, opt)
    flops = 6 * n * B * S
    peak_bf16 = peaks(torch.cuda.get_device_name(0))[1][1]
    cut = (f"depth {base_cfg.num_layers} -> {cfg.num_layers}"
           if cfg.num_layers != base_cfg.num_layers else "none")
    emit(phase="train", arch=arch, layers=cfg.num_layers, cut=cut,
         dtype="bfloat16", batch=B, seq=S, steps=steps, params=n,
         losses=[rec["loss"] for rec in hist], median_step_ms_2_5=median_s
         * 1e3, tokens_per_s=B * S / median_s, model_flops_per_step=flops,
         model_flops_share_of_bf16_peak=flops / median_s / peak_bf16,
         bf16_peak_tflops=peak_bf16 / 1e12, peak_mem_bytes=peak,
         split=split, health=hist.health, launches=snap["launches"],
         routes=snap["routes"], log=logs, nvidia_smi=smi)
    if len(hist) != steps or any(not math.isfinite(r["loss"]) for r in hist):
        raise AssertionError(f"train {arch}: losses "
                             f"{[r['loss'] for r in hist]}")
    if any(r["skipped"] for r in hist) or state["skipped_steps"]:
        raise AssertionError(f"train {arch}: a step was skipped")
    want = {k: v * steps for k, v in expected_launches(cfg, 0).items()}
    if snap["launches"] != want:
        raise AssertionError(f"train {arch}: launches {snap['launches']}, "
                             f"expected {want}")
    for name in ("flash_attention", "ssd_scan"):   # bf16: the tensor cores
        routes = {"tensor_core": want[name], "tf32x3": 0}
        if snap["routes"][name] != routes:
            raise AssertionError(f"train {arch}: {name} routes "
                                 f"{snap['routes'][name]}")
    return snap, card_step(cfg, state, opt, B, S, base)


def serve_cell(arch, layers, B, S):
    """The card's side of a phase-18 serve cell: ``ServeEngine``'s prefill
    of a (B, S) prompt and one decode step on a cache of S + 1 positions
    (a warm-up first), timed (synchronised) with the launch counts and the
    peak bytes above what was allocated before the parameters."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(18)
    engine = ServeEngine(cfg, init_params(cfg, gen, "cuda"), max_seq=S + 1,
                         batch_size=B)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")

    def request():
        t0 = time.perf_counter()
        logits, cache = engine.prefill(prompt)
        tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.decode_step(cache, tok, S)
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    request()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    prefill_ms, decode_ms = request()
    out = {"ms": prefill_ms + decode_ms, "prefill_ms": prefill_ms,
           "decode_ms": decode_ms,
           "peak_bytes": torch.cuda.max_memory_allocated() - base,
           **snapshot()}
    del engine, prompt
    return out


def phase_dryrun(smi, cells):
    """18. The dry run held against the card: for each of ``DRYRUN_CELLS``,
    after the card has run it, the one-device meta trace
    (``launch.dryrun.world1_cell``, in this process): its kernel calls
    (equal to the card's launches by kernel and route), its predicted peak
    (within DRYRUN_PEAK_TOL of the card's) and its roofline bound beside
    the measured time (a share, no pass or fail).  ``cells`` holds the
    train cells phases 8 and 17 measured; the serve cell is measured
    here."""
    _, arch, layers, B, S = DRYRUN_CELLS[f"serve {GLM}"]
    cells[f"serve {GLM}"] = serve_cell(arch, layers, B, S)
    out = {}
    for name, spec in DRYRUN_CELLS.items():
        pred, card = dryrun.world1_cell(*spec), cells[name]
        want = {k: v for k, v in card["launches"].items() if v}
        want_routes = {k: {r: n for r, n in v.items() if n}
                       for k, v in card["routes"].items()}
        want_routes = {k: v for k, v in want_routes.items() if v}
        got_routes = {k: v for k, v in pred["kernel_routes"].items()
                      if k in ops.ROUTE_LAUNCHES}
        peak = pred["memory"]["peak_per_device_GiB"] * 2**30
        bound_s = pred["roofline"]["t_bound_s"]
        row = {"kernel_calls": pred["kernel_calls"], "card_launches": want,
               "kernel_routes": got_routes, "card_routes": want_routes,
               "predicted_peak_bytes": peak,
               "card_peak_bytes": card["peak_bytes"],
               "peak_ratio": peak / card["peak_bytes"],
               "bound_ms": bound_s * 1e3, "bound_by":
               pred["roofline"]["bottleneck"], "card_ms": card["ms"],
               "bound_share_of_card": bound_s * 1e3 / card["ms"],
               "roofline": pred["roofline"], "trace_s": pred["trace_s"],
               "source": pred["source"]}
        if "prefill_ms" in card:
            row.update(prefill_ms=card["prefill_ms"],
                       decode_ms=card["decode_ms"])
        out[name] = row
        emit(phase="dryrun_vs_card", cell=name, **row, nvidia_smi=smi)
        if pred["kernel_calls"] != want or got_routes != want_routes:
            raise AssertionError(f"dry run {name}: kernel calls "
                                 f"{pred['kernel_calls']} {got_routes}, card "
                                 f"{want} {want_routes}")
        if abs(row["peak_ratio"] - 1) > DRYRUN_PEAK_TOL:
            raise AssertionError(f"dry run {name}: predicted peak {peak} B, "
                                 f"card {card['peak_bytes']} B")
    return out


def phase_dist(smi):
    """Eq. 13 for every primitive, LinearOp and memory operator on the
    card, in a world of one NCCL rank per card; prints ``{"dist": ...}``
    with each check's relative error and each collective's time."""
    gc.collect()
    torch.cuda.empty_cache()   # the spawned ranks share the card(s)
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    ranks = launch_mesh.spawn(
        functools.partial(dist_check.run, shapes=dist_check.FULL), world,
        device="cuda", timeout_s=600)
    res = ranks[0]
    print(json.dumps({"dist": {
        "world": res["world"], "backend": res["backend"],
        "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "shapes": dist_check.FULL, "seconds": time.perf_counter() - t0,
        "rel_err": res["rel_err"], "eps": res["eps"],
        "failed": res["failed"], "timing": res["timing"]}}), flush=True)
    if res["backend"] != "nccl" or res["world"] != world:
        raise AssertionError(f"dist: {res['backend']} world {res['world']}, "
                             f"expected nccl world {world}")
    failed = sorted({c for r in ranks for c in r["failed"]})
    if failed:
        raise AssertionError(f"dist: Eq. 13 fails for {failed}")


def region_tp_rank(rank, world_mesh, *, shape):
    """glm4-9b's sublayer at full width on this rank: the explicit-TP
    region against the ordinary sublayer, in fp32 and bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = launch_mesh.make_host_mesh(shape, ("data", "model"), device="cuda")
    policy = Policy(m, explicit_tp=True, fsdp=False, seq_shard=False)
    B, S, iters = REGION["batch"], REGION["seq"], REGION["iters"]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(get_config(GLM), dtype=str(dtype)[6:])
        gen = torch.Generator(device="cuda").manual_seed(3)
        params = {k: v[0] for k, v in
                  sublayer_init(cfg, 0, dtype, gen, 1).items()}
        x = randn((B, S, cfg.d_model), dtype, gen)
        cot = randn((B, S, cfg.d_model), dtype, gen)
        pos = torch.arange(S, device="cuda").expand(B, S)

        def run(pol):
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            y, _, _ = sublayer_apply(p, x, cfg, 0, positions=pos,
                                     mode="train", policy=pol)
            grads = torch.autograd.grad(y, list(p.values()), cot)
            return y.detach(), dict(zip(p, grads))

        ops.reset_launches()
        y_tp, g_tp = run(policy)
        torch.cuda.synchronize()
        snap = snapshot()
        y_ref, g_ref = run(None)
        name = f"region tp sublayer {GLM} {cfg.dtype}"
        if dtype == torch.float32:
            err = {"y": check_close(f"{name} y", y_tp, y_ref, TP_FWD_TOL)}
            err.update({k: check_close(f"{name} grad {k}", g_tp[k], g_ref[k],
                                       TP_GRAD_TOL) for k in g_ref})
        else:
            err = {"y": check_scaled(f"{name} y", y_tp, y_ref,
                                     BF16_PARITY_TOL)}
            err.update({k: check_scaled(f"{name} grad {k}", g_tp[k],
                                        g_ref[k], BF16_PARITY_TOL)
                        for k in g_ref})
        del y_tp, g_tp, y_ref, g_ref
        flash = snap["routes"]["flash_attention"]
        want = {r: int(r == ROUTES[dtype]) for r in flash}
        if flash != want or snap["launches"]["flash_attention"] != 1:
            raise AssertionError(f"{name}: flash launches {snap}, expected "
                                 f"one on {ROUTES[dtype]}")
        # in turns (region, ordinary, ordinary, region), then each one's
        # device time: a gap in the events but not on the device is the
        # host's dispatch
        pols = {"region": policy, "ordinary": None}
        ms = {name: [] for name in pols}
        for name in ("region", "ordinary", "ordinary", "region"):
            ms[name].append(event_ms(lambda: run(pols[name]), iters))
        device = {name: dist_check.device_activity(lambda: run(pol), 3)
                  for name, pol in pols.items()}
        out[cfg.dtype] = {"launches": snap, "errors": err,
                          "fwd_bwd_ms": ms, "device": device, "params": sum(
                              v.numel() for v in params.values())}
        del params
        torch.cuda.empty_cache()
    return out


def phase_region(smi):
    """The region layer on the card: LeNet-5 §5 through the example's main,
    then glm4-9b's TP sublayer at full width in a world of one NCCL rank
    per card.  Prints ``{"region": ...}``; returns the sublayer's launch
    counts by path."""
    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    shape = (2, 2) if cards >= 4 else (1, 1)
    t0 = time.perf_counter()
    lenet = lenet_example.main(["--device", "cuda", "--mesh",
                                ",".join(map(str, shape))])
    if not lenet["within_pins"] or abs(lenet["acc_dist"]
                                       - lenet["acc_seq"]) >= 0.02:
        raise AssertionError(f"region: LeNet distributed != sequential: "
                             f"{lenet}")
    lenet_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = launch_mesh.spawn(functools.partial(region_tp_rank, shape=shape),
                              math.prod(shape), device="cuda", timeout_s=900)
    tp = ranks[0]
    print(json.dumps({"region": {
        "mesh": list(shape), "world": math.prod(shape), "kind":
        torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "lenet": {k: lenet[k] for k in (
            "steps", "batch", "acc_dist", "acc_seq", "ms_per_step_dist",
            "ms_per_step_seq", "fwd_max_abs_err", "grad_max_abs_err")},
        "lenet_final_losses": {k: v[-1] for k, v in lenet["losses"].items()},
        "lenet_seconds": lenet_s,
        "tp_sublayer": {"arch": GLM, "batch": REGION["batch"],
                        "seq": REGION["seq"], **tp},
        "tp_seconds": time.perf_counter() - t0}}), flush=True)
    return {f"region tp sublayer {dtype} {GLM}": tp[dtype]["launches"]
            for dtype in tp}


def hybrid_launches(cfg, policy, ticks_of, M=None):
    """The launches this rank makes (PERF.md §6): each layer of its stage
    launches flash once and, outside explicit TP (whose body normalises
    with the plain sharded norm), RMSNorm twice, on every B tick and on
    every F tick but the last stage's (it skips them); the last stage adds
    the final norm on each B tick.  ``ticks_of(n_f, n_b)`` scales a run's
    F and B tick counts; M microbatches (``HYBRID["micro"]`` by default).
    Under a live ctx axis attention rings in plain torch: no flash."""
    S, M = policy.pipe_size, M or HYBRID["micro"]
    s = policy.mesh.get_coordinate()[policy.axis_names.index("pipe")]
    last = s == S - 1
    ticks = ticks_of(0 if last else M, M)
    per = cfg.num_layers // S
    norms = 0 if policy.explicit_tp else 2 * per
    return {"flash_attention": 0 if policy.active_ctx_axis else per * ticks,
            "rmsnorm": norms * ticks + (ticks_of(0, M) if last else 0),
            "ssd_scan": 0}


def hybrid_parity(policy, B=HYBRID["batch"], S=HYBRID["seq"],
                  M=HYBRID["micro"], schedules=("1f1b", "fill_drain")):
    """(a): fp32 glm4-9b cut to 2 layers, B 4, S 1024, M 4 (or the sizes
    given), each schedule through ``build_hybrid_value_and_grad`` (global
    arguments, every rank) against ``loss_and_grads`` on the dense params
    on rank 0's card: the reference's pins, and each grad leaf also to
    PARITY_TOL of its own largest |value| as phase 7 holds it (at full
    width most grad elements lie below the pins' atol, so the pins alone
    would pass a leaf that lost a microbatch's or a shard's share);
    returns {schedule: (launches, errors, loss, single-device loss)},
    errors with each leaf's scale."""
    cfg = dataclasses.replace(get_config(GLM),
                              num_layers=HYBRID["parity_layers"],
                              dtype="float32")
    pp = init_pipeline_params(
        cfg, torch.Generator(device="cuda").manual_seed(7), policy.pipe_size,
        "cuda")
    batch = batch_to_device(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
        seed=0)).batch(0), "cuda")
    root = torch.distributed.get_rank() == 0
    if root:
        loss_r, _, grads_r = loss_and_grads(build_loss_fn(cfg),
                                            from_pipeline_params(pp), batch)
    out = {}
    for schedule in schedules:
        pvg, _ = build_hybrid_value_and_grad(cfg, policy, num_microbatches=M,
                                             schedule=schedule)
        ops.reset_launches()
        loss, grads = pvg(pp, {"tokens": batch["tokens"].reshape(M, B // M,
                                                                 S)},
                          batch["labels"].reshape(M, B // M, S))
        torch.cuda.synchronize()
        snap = snapshot()
        want = hybrid_launches(cfg, policy, lambda f, b: f + b, M)
        if (snap["launches"] != want
                or snap["routes"]["flash_attention"]["tf32x3"]
                != want["flash_attention"]):
            raise AssertionError(f"hybrid parity {schedule}: launches "
                                 f"{snap}, expected {want} (3xTF32)")
        err = {}
        if root:
            grads = from_pipeline_params(grads)
            err = {"loss": abs(float(loss) - float(loss_r))
                   / abs(float(loss_r))}
            bad = []
            for k, g in grads.items():
                d = (g - grads_r[k]).abs()
                scale = float(grads_r[k].abs().max())
                err[k] = {"max_abs_err": float(d.max()), "scale": scale}
                if (bool((d > HYBRID_GRAD_TOL + HYBRID_GRAD_TOL
                          * grads_r[k].abs()).any())
                        or err[k]["max_abs_err"] > PARITY_TOL * scale
                        or not bool(torch.isfinite(g).all())):
                    bad.append(k)
            if err["loss"] > HYBRID_LOSS_RTOL or bad:
                raise AssertionError(
                    f"hybrid parity {schedule}: loss rel err {err['loss']}, "
                    f"grads off the pin: {bad}")
        out[schedule] = (snap, err, float(loss),
                         float(loss_r) if root else None)
        del grads
    return out


def hybrid_split(cfg, policy, state, batch, steps):
    """One more step of the trained state, split by CUDA events at the
    executor's phase hook into F ticks, B ticks, idle ticks, the boundary
    shifts (the hop and the wait for the other stage), the drain tail and
    the optimizer."""
    marks = []

    def hook(kind):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((kind, ev))

    opt = make_optimizer(cfg.optimizer, total_steps=steps,
                         base_lr=TRAIN["lr"])
    step = build_hybrid_train_step(cfg, policy, opt,
                                   num_microbatches=HYBRID["micro"],
                                   phase_hook=hook)
    torch.cuda.synchronize()
    hook("start")
    state, met = step(state, batch)
    hook("end")
    marks[-1][1].synchronize()
    split = {}
    for (kind, a), (_, b) in zip(marks[1:-1], marks[2:]):
        split[kind] = split.get(kind, 0.0) + a.elapsed_time(b)
    split["before_first_tick"] = marks[0][1].elapsed_time(marks[1][1])
    if int(met["skipped"]):
        raise AssertionError("hybrid split step: skipped")
    return state, {f"{k}_ms": v for k, v in split.items()}


def hybrid_guard(cfg, policy, state, batch, steps):
    """(c): one step through a fault hook that poisons a gradient leaf on
    the last rank only; every rank must skip it with params and moments
    bitwise unchanged (compared against host copies, leaf by leaf)."""
    leaf = "stage.pos0.mlp.w_up"
    poisoned = torch.distributed.get_world_size() - 1

    def poison(grads):
        if torch.distributed.get_rank() != poisoned:
            return grads
        return dict(grads, **{leaf: grads[leaf] + float("nan")})

    opt = make_optimizer(cfg.optimizer, total_steps=steps,
                         base_lr=TRAIN["lr"])
    step = build_hybrid_train_step(cfg, policy, opt,
                                   num_microbatches=HYBRID["micro"],
                                   fault_hook=poison)
    before = {"params": {k: v.cpu() for k, v in state["params"].items()},
              "m": {k: v.cpu() for k, v in state["opt"]["m"].items()},
              "v": {k: v.cpu() for k, v in state["opt"]["v"].items()}}
    step_before, skipped_before = state["step"], state["skipped_steps"]
    state, met = step(state, batch)
    after = {"params": state["params"], "m": state["opt"]["m"],
             "v": state["opt"]["v"]}
    changed = [f"{part}.{k}" for part, tree in before.items()
               for k, v in tree.items() if not torch.equal(after[part][k]
                                                          .cpu(), v)]
    out = {"skipped": int(met["skipped"]), "changed": changed,
           "step": [step_before, state["step"]],
           "skipped_steps": [skipped_before, state["skipped_steps"]],
           "poisoned_rank": poisoned, "poisoned_leaf": leaf}
    if (out["skipped"] != 1 or changed or state["step"] != step_before + 1
            or state["skipped_steps"] != skipped_before + 1):
        raise AssertionError(f"hybrid guard: {out}")
    return out


def hybrid_rank(rank, world_mesh, *, mesh):
    """Phase 11 on this rank of the (dp, pp, cp, tp, ep) ``mesh``: (a)
    parity, (b) 5 bf16 steps through the CLI's per-rank path, the split
    step, (c) the guard."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank}
    dp, pp, cp, tp, ep = mesh
    m = launch_mesh.make_hybrid_mesh(dp, pp, cp, tp, ep, device="cuda")
    policy = Policy.for_mesh(m, explicit_tp=tp > 1)
    out["coordinate"] = dict(zip(policy.axis_names, m.get_coordinate()))
    t0 = time.perf_counter()
    parity = hybrid_parity(policy)
    out["parity"] = {k: {"launches": v[0], "errors": v[1], "loss": v[2],
                         "loss_single_device": v[3]}
                     for k, v in parity.items()}
    out["parity_seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(GLM), num_layers=TRAIN["layers"])
    B, S, M, steps = TRAIN["batch"], TRAIN["seq"], HYBRID["micro"], \
        TRAIN["steps"]
    logs = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, hist, policy = launch_train.train_hybrid_rank(
        cfg, mesh, steps=steps, batch=B, seq=S, microbatches=M,
        schedule="1f1b", lr=TRAIN["lr"], seed=0, device="cuda",
        logger=logs.append)
    torch.cuda.synchronize()
    snap = snapshot()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    secs = sorted(rec["sec"] for rec in hist[1:])
    median_s = (secs[(len(secs) - 1) // 2] + secs[len(secs) // 2]) / 2
    n = sum(p.numel() for p in state["params"].values())
    out["train"] = {
        "arch": GLM, "layers": cfg.num_layers, "cut": "depth 40 -> 8",
        "dtype": cfg.dtype, "mesh": list(mesh), "batch": B,
        "seq": S, "microbatches": M, "schedule": "1f1b", "steps": steps,
        "params_on_rank": n, "losses": [rec["loss"] for rec in hist],
        "grad_norms": [rec["grad_norm"] for rec in hist],
        "step_ms": [rec["sec"] * 1e3 for rec in hist],
        "median_step_ms_2_5": median_s * 1e3,
        "tokens_per_s": B * S / median_s,
        "bubble_fraction": hist[-1]["bubble_fraction"],
        "peak_mem_bytes": peak, "health": hist.health,
        "launches": snap, "seconds": train_s, "log": logs}
    if len(hist) != steps or any(not math.isfinite(r["loss"])
                                 or r["skipped"] for r in hist):
        raise AssertionError(f"hybrid train: {out['train']['losses']}, "
                             f"skipped {[r['skipped'] for r in hist]}")
    want = hybrid_launches(cfg, policy, lambda f, b: steps * (f + b))
    routes = {"tensor_core": want["flash_attention"], "tf32x3": 0}
    if snap["launches"] != want or snap["routes"]["flash_attention"] != routes:
        raise AssertionError(f"hybrid train: launches {snap}, expected "
                             f"{want}, flash routes {routes}")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    state, out["split"] = hybrid_split(cfg, policy, state, data.batch(steps),
                                       steps)
    out["guard"] = hybrid_guard(cfg, policy, state, data.batch(steps + 1),
                                steps)
    return out


def phase_hybrid(smi):
    """Phase 11: the hybrid step over NCCL, one rank per card, at mesh
    (1, 1, 1) on one card and (dp, pipe, model) = (1, 2, 2) where 4 cards
    or more exist.  Prints ``{"hybrid": ...}`` (rank 0's results, and each
    rank's launches, split, peak memory and guard); returns the launch
    counts by path, summed over the ranks."""
    gc.collect()
    torch.cuda.empty_cache()
    mesh = HYBRID_MESHES[4 if torch.cuda.device_count() >= 4 else 1]
    world = math.prod(mesh)
    t0 = time.perf_counter()
    ranks = launch_mesh.spawn(functools.partial(hybrid_rank, mesh=mesh),
                              world, device="cuda", timeout_s=900)
    res = ranks[0]
    for r in ranks:
        if (r["train"]["losses"] != res["train"]["losses"]
                or {k: v["loss"] for k, v in r["parity"].items()}
                != {k: v["loss"] for k, v in res["parity"].items()}):
            raise AssertionError(f"hybrid: rank {r['rank']} disagrees")
    print(json.dumps({"hybrid": {
        "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "world": world, "backend": "nccl", **res,
        "ranks": [{"rank": r["rank"], "coordinate": r["coordinate"],
                   "launches": r["train"]["launches"]["launches"],
                   "peak_mem_bytes": r["train"]["peak_mem_bytes"],
                   "params_on_rank": r["train"]["params_on_rank"],
                   "split": r["split"], "guard": r["guard"]}
                  for r in ranks],
        "seconds": time.perf_counter() - t0}}), flush=True)

    def total(snaps):
        out = {"launches": {}, "routes": {}}
        for snap in snaps:
            for k, v in snap["launches"].items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            for k, rs in snap["routes"].items():
                mine = out["routes"].setdefault(k, {})
                for r, v in rs.items():
                    mine[r] = mine.get(r, 0) + v
        return out

    paths = {f"hybrid parity fp32 {s} {GLM}": total(
        r["parity"][s]["launches"] for r in ranks) for s in res["parity"]}
    paths[f"hybrid bf16 {GLM}"] = total(r["train"]["launches"]
                                        for r in ranks)
    return paths


# ---------------------------------------------------------------------------
# Phase 12: MoE and expert parallelism, jamba-v0.1-52b.
# ---------------------------------------------------------------------------

def jamba_cfg(dtype="bfloat16"):
    """jamba-v0.1-52b at its published widths, depth cut from 32 layers to
    one 8-layer period (attention at 4, MoE on the odd layers)."""
    return dataclasses.replace(get_config(JAMBA),
                               num_layers=MOE["layers"], dtype=dtype)


def layer_params(params, i):
    """Layer ``i``'s leaves of a one-superblock model, as views."""
    pre = f"blocks.pos{i}."
    return {k[len(pre):]: v[0] for k, v in params.items()
            if k.startswith(pre)}


def moe_kernel_checks():
    """(a): each kernel against its plain version at the shapes jamba gives
    it, and the jamba-shape timing rows (emitted, not in the kernels'
    line): the SSD scan bf16 (B 4, S 1024, H 128, P 64, N 16, chunk 64);
    RMSNorm at 4096 and at 8192 (the gated norm over d_inner); flash
    attention bf16 with GQA group 4 (32 over 8 heads, hd 128, causal)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf16 = torch.bfloat16
    B, S, H, P, N, L = 4, 1024, 128, 64, 16, 64
    args = ssd_inputs(B, S, H, P, N, bf16, gen, model=True)
    before = dict(ops.ROUTE_LAUNCHES["ssd_scan"])
    y, h = ops.ssd_scan(*args, chunk=L)
    expect_routes("ssd_scan", bf16, before)
    case = f"moe ssd tc {JAMBA} B={B} S={S} H={H} P={P} N={N} L={L}"
    err = 0.0
    for plain, (want_y, want_h) in (
            ("ssd_ref", ref.ssd_ref(*args)),
            ("ssd_chunked", ref.ssd_chunked(*args, chunk=L))):
        torch.cuda.synchronize()
        err = max(err, check_close(f"{case} y vs {plain}", y, want_y,
                                   SSD_TOL[bf16]),
                  check_close(f"{case} h_final vs {plain}", h, want_h,
                              SSD_TOL[torch.float32]))
    timing_row(
        "ssd_scan", "cuda", ROUTES[bf16], bf16, "tensor (mma.sync)",
        "src/repro_torch/kernels/csrc/ssd_scan_tc.cu",
        "src/repro/kernels/ssd_scan.py:60", "kernels/ssd_scan.py::ssd_scan_fwd",
        f"{JAMBA}: x ({B},{S},{H},{P}) B/C ({B},{S},{N}) bf16, chunk {L}",
        err, lambda: ops.ssd_scan(*args, chunk=L),
        lambda: ref.ssd_chunked(*args, chunk=L), None,
        kernel_cost("ssd_scan", *(t.shape for t in args),
                    dtype=bf16, chunk=L), iters=10)
    for rows, d in MOE_NORM_CASES:
        for dtype in (torch.float32, bf16):
            x = randn((rows, d), dtype, gen)
            w = 1.0 + 0.1 * randn((d,), torch.float32, gen)
            check_close(f"moe rmsnorm {JAMBA} rows={rows} d={d} {dtype}",
                        ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w),
                        NORM_TOL[dtype])
    x = randn((B * S, 8192), bf16, gen)
    w = 1.0 + 0.1 * randn((8192,), torch.float32, gen)
    timing_row(
        "rmsnorm", "triton", "triton", bf16, "CUDA cores",
        "src/repro_torch/kernels/rmsnorm.py", "src/repro/kernels/rmsnorm.py:24",
        "kernels/rmsnorm.py::rmsnorm_fwd",
        f"{JAMBA} gated norm: x ({B * S},8192) bf16, w (8192,) fp32",
        check_close("moe rmsnorm d=8192 timing shape", ops.rmsnorm(x, w),
                    ref.rmsnorm_ref(x, w), NORM_TOL[bf16]),
        lambda: ops.rmsnorm(x, w), lambda: ref.rmsnorm_ref(x, w),
        lambda: F.rms_norm(x, (8192,), w.to(bf16), 1e-6),
        kernel_cost("rmsnorm", x.shape, w.shape, dtype=bf16,
                    w_dtype=w.dtype), iters=100)
    Hq, KH, hd = 32, 8, 128
    q, k, v = (randn((B, S, n, hd), bf16, gen) for n in (Hq, KH, KH))
    before = dict(ops.ROUTE_LAUNCHES["flash_attention"])
    got = ops.flash_attention(q, k, v, causal=True)
    expect_routes("flash_attention", bf16, before)
    err = check_close(f"moe flash tc {JAMBA} B={B} S={S} H={Hq} KH={KH} "
                      f"hd={hd} causal", got,
                      ref.attention_ref(q, k, v, causal=True),
                      FLASH_TOL[bf16])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    timing_row(
        "flash_attention", "cuda", ROUTES[bf16], bf16, "tensor (wgmma)",
        "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "src/repro/kernels/flash_attention.py:69",
        "kernels/flash_attention.py::flash_attention_fwd",
        f"{JAMBA}: q ({B},{S},{Hq},{hd}) k/v ({B},{S},{KH},{hd}) bf16 causal",
        err, lambda: ops.flash_attention(q, k, v),
        lambda: ref.attention_ref(q, k, v),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        kernel_cost("flash_attention", q.shape, k.shape, v.shape,
                    dtype=bf16))


def routing(x, router, cfg):
    """The top-k choices and the kept mask of ``moe._dispatch_combine_local``
    for tokens x (T, d), with the router probabilities."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    _, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    T, k, E = x.shape[0], cfg.experts_per_token, cfg.num_experts
    cap = int(math.ceil(T * k / E * cfg.capacity_factor))
    order, _, keep, _, _ = moe.dispatch_plan(idx, E, cap)
    kept = torch.zeros(T * k, dtype=torch.bool, device=x.device)
    kept[order] = keep
    return probs, idx, kept.reshape(T, k)


def moe_ffn_parity(smi):
    """(b): the MoE FFN at jamba's full width (E 16, top-2, d 4096, h 14336,
    one layer, 2.82B parameters), fp32, T = 512 tokens, card vs host: y
    within PARITY_TOL of its scale, aux within 1e-5 relative, the top-k
    choices and the kept slot sets equal (a flip is reported with its
    router-probability gap), the grads of ``sum(y * c) + aux`` for x, the
    router and the three expert weights within PARITY_TOL of each leaf's
    scale."""
    cfg = jamba_cfg("float32")
    T = MOE["ffn_tokens"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    p = moe.moe_init(cfg, torch.float32, gen)
    x = randn((1, T, cfg.d_model), torch.float32, gen)
    cot = randn((1, T, cfg.d_model), torch.float32, gen)

    def run(pp, xx, cc):
        leaves = {k: v.detach().requires_grad_() for k, v in pp.items()}
        xx = xx.detach().requires_grad_()
        y, aux = moe.moe_apply(xx, leaves, cfg, None)
        grads = torch.autograd.grad((y * cc).sum() + aux,
                                    [xx] + list(leaves.values()))
        return y.detach(), aux.detach(), dict(zip(["x"] + list(leaves),
                                                  grads))

    ops.reset_launches()
    t0 = time.perf_counter()
    y_g, aux_g, g_g = run(p, x, cot)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launched = dict(ops.LAUNCHES)
    route_g = routing(x[0], p["router"], cfg)
    host = {k: v.cpu() for k, v in p.items()}
    del p
    t0 = time.perf_counter()
    y_c, aux_c, g_c = run(host, x.cpu(), cot.cpu())
    host_s = time.perf_counter() - t0
    probs_c, idx_c, kept_c = routing(x[0].cpu(), host["router"], cfg)
    flips = (route_g[1].cpu() != idx_c).any(-1).nonzero()[:, 0].tolist()
    top = torch.topk(probs_c, cfg.experts_per_token + 1, dim=-1).values
    gaps = (top[:, -2] - top[:, -1])[flips].tolist()
    kept_equal = bool(torch.equal(route_g[2].cpu(), kept_c))
    out = {"tokens": T, "params": sum(v.numel() for v in host.values()),
           "topk_flips": flips, "flip_prob_gaps": gaps,
           "min_topk_prob_gap": float((top[:, -2] - top[:, -1]).min()),
           "kept_equal": kept_equal, "dropped": int((~kept_c).sum()),
           "card_s": card_s, "host_s": host_s, "launches": launched,
           "aux": [float(aux_g), float(aux_c)]}
    out["y_share"] = check_scaled(f"moe ffn {JAMBA} y", y_g.cpu(), y_c,
                                  PARITY_TOL)
    aux_rel = abs(float(aux_g) - float(aux_c)) / abs(float(aux_c))
    emit(phase="check", case=f"moe ffn {JAMBA} aux", rel_err=aux_rel,
         tol=MOE_AUX_RTOL)
    out["grad_shares"] = {k: check_scaled(f"moe ffn {JAMBA} grad {k}",
                                          g.cpu(), g_c[k], PARITY_TOL)
                          for k, g in g_g.items()}
    emit(phase="moe_ffn", arch=JAMBA, **out, nvidia_smi=smi)
    if flips or not kept_equal or aux_rel > MOE_AUX_RTOL:
        raise AssertionError(f"moe ffn: top-k flips {flips} (gaps {gaps}), "
                             f"kept sets equal {kept_equal}, aux rel "
                             f"{aux_rel}")
    if any(launched.values()):
        raise AssertionError(f"moe ffn: kernels launched {launched}")


def sublayer_halves(p, x, cfg, i, pos, h_ffn=None):
    """Sublayer ``i`` of ``models/blocks.py::sublayer_apply`` in prefill, cut
    in two: the mixer half ``x1 = x + mixer(norm(x))`` with its cache
    entries, and the FFN half ``y = ffn(h)`` on ``h_ffn`` (default
    ``norm(x1)``, the sublayer's own).  Returns (x1, kv, h, y, aux)."""
    h = rmsnorm(x, p["norm_mixer"])
    if cfg.mixer_kind(i) == "attn":
        out, kv = attention_block(subtree(p, "attn"), h, cfg, positions=pos,
                                  mode="prefill")
    else:
        out, kv = ssm_block(subtree(p, "ssm"), h, cfg, mode="prefill")
    x1 = x + out
    h = rmsnorm(x1, p["norm_ffn"]) if h_ffn is None else h_ffn
    if cfg.ffn_kind(i) == "moe":
        y, aux = moe.moe_apply(h, subtree(p, "moe"), cfg)
    else:
        y, aux = mlp_apply(h, subtree(p, "mlp"), cfg.mlp_type), None
    return x1, kv, h, y, aux


def moe_layer_parity(cfg, params, smi):
    """(c): each of the 8 sublayers of the served bf16 model on the card
    against the host's fp32 sublayer on the same input (the card's output
    of the layer before), in prefill, B 1, prompt 64.  A top-k choice is
    discrete, and the card's bf16 mixer moves the router's input by ~2^-9,
    which flips near-tied choices and moves a token's FFN output by its
    scale; so each half is held on the same input: the mixer half (the
    residual after it and the cache entries) on the sublayer's input, the
    FFN half (output and aux) on the card's normed FFN input, whose router
    logits are then fp32 products of the same values on both sides.  Each
    within BF16_PARITY_TOL of its scale; an MoE half's top-k choices and
    kept slots equal; the halves together are ``sublayer_apply`` (within
    PARITY_TOL).  The flips the whole sublayer would see are counted.  The
    host holds one sublayer's weights at a time."""
    B, S = 1, MOE["parity_prompt"]
    gen = torch.Generator(device="cuda").manual_seed(14)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    pos = torch.arange(S, device="cuda")[None, :].expand(B, S)
    host_cfg = dataclasses.replace(cfg, dtype="float32")
    x = params["embed"][tokens].to(torch.bfloat16)
    out = {}
    for i in range(cfg.block_period):
        p = layer_params(params, i)
        name = (f"moe parity bf16 {JAMBA} layer {i} "
                f"({cfg.mixer_kind(i)}+{cfg.ffn_kind(i)})")
        with torch.no_grad():
            x2 = sublayer_apply(p, x, cfg, i, positions=pos,
                                mode="prefill")[0]
            x1, kv, h, y, aux = sublayer_halves(p, x, cfg, i, pos)
            hp = {k: v.float().cpu() for k, v in p.items()}
            x1_c, kv_c, h_c, y_c, aux_c = sublayer_halves(
                hp, x.float().cpu(), host_cfg, i, pos.cpu(),
                h_ffn=h.float().cpu())
            own_h = rmsnorm(x1_c, hp["norm_ffn"])
        del hp
        res = {"halves_vs_sublayer": check_scaled(f"{name} halves", x1 + y,
                                                  x2, PARITY_TOL),
               "x1": check_scaled(f"{name} mixer half", x1.cpu(), x1_c,
                                  BF16_PARITY_TOL),
               "y": check_scaled(f"{name} ffn half", y.cpu(), y_c,
                                 BF16_PARITY_TOL)}
        for leaf in kv_c:
            res[leaf] = check_scaled(f"{name} {leaf}", kv[leaf].cpu(),
                                     kv_c[leaf], BF16_PARITY_TOL)
        if aux is not None:
            res["aux"] = check_scaled(f"{name} aux", aux.cpu(), aux_c,
                                      BF16_PARITY_TOL)
            router = p["moe.router"]
            _, idx, kept = routing(h[0], router, cfg)
            _, idx_c, kept_c = routing(h_c[0], router.cpu(), cfg)
            _, idx_own, _ = routing(own_h[0], router.cpu(), cfg)
            res["topk_flips"] = int((idx.cpu() != idx_c).any(-1).sum())
            res["kept_equal"] = bool(torch.equal(kept.cpu(), kept_c))
            res["flips_whole_sublayer"] = int(
                (idx.cpu() != idx_own).any(-1).sum())
            if res["topk_flips"] or not res["kept_equal"]:
                raise AssertionError(f"{name}: routing differs on the same "
                                     f"input: {res}")
        out[i] = res
        x = x2
        gc.collect()
    emit(phase="moe_layer_parity", arch=JAMBA, batch=B, prompt_len=S,
         layers=out, nvidia_smi=smi)
    return out


def moe_serve(cfg, params, smi):
    """(d): the bf16 model served through ``ServeEngine`` (B 4, prompt
    1024, 32 greedy steps): a warm-up run, then the measured run with the
    launch counts read around it; then one decode step's busy share."""
    B, S, steps = MOE["batch"], MOE["prompt_len"], MOE["steps"]
    gen = torch.Generator(device="cuda").manual_seed(15)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    engine = ServeEngine(cfg, params, max_seq=S + steps + 8, batch_size=B)
    engine.generate(prompt, 2)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    tokens = engine.generate(prompt, steps).cpu()
    snap = snapshot()
    peak = torch.cuda.max_memory_allocated()
    st = engine.stats
    row = {"arch": JAMBA, "layers": cfg.num_layers, "cut": "depth 32 -> 8",
           "dtype": cfg.dtype, "batch": B, "prompt_len": S, "steps": steps,
           "params": sum(v.numel() for v in params.values()),
           "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "prefill_tok_s": B * S / st["prefill_s"],
           "decode_tok_s": B * steps / st["decode_s"],
           "peak_mem_bytes": peak, "launches": snap["launches"],
           "routes": snap["routes"], "tokens": tokens[0].tolist(),
           "nvidia_smi": smi}
    if not st["logits_finite"]:
        raise AssertionError(f"{JAMBA}: non-finite logits")
    if tokens.shape != (B, steps) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"{JAMBA}: tokens out of range")
    want = expected_launches(cfg, steps)
    if snap["launches"] != want or want != MOE["launches"]:
        raise AssertionError(f"{JAMBA}: launches {snap['launches']}, "
                             f"expected {want} = {MOE['launches']}")
    for name in ("flash_attention", "ssd_scan"):   # bf16: the tensor cores
        routes = {"tensor_core": want[name], "tf32x3": 0}
        if snap["routes"][name] != routes:
            raise AssertionError(f"{JAMBA}: {name} routes "
                                 f"{snap['routes'][name]}, expected {routes}")
    row["decode"] = decode_busy(engine, prompt)
    emit(phase="moe_serve", **row)
    return snap


def moe_sublayer_ms(cfg, policy=None):
    """(f): the MoE FFN sub-layer at full width, bf16, B 2, S 1024: forward
    and forward + backward ms by CUDA events (``policy`` None: ep 1; else
    ``moe_apply``'s region over the policy's ep axis, on every rank)."""
    B, S = MOE["time_batch"], MOE["time_seq"]
    gen = torch.Generator(device="cuda").manual_seed(16)
    p = moe.moe_init(cfg, torch.bfloat16, gen)
    x = randn((B, S, cfg.d_model), torch.bfloat16, gen)
    cot = randn((B, S, cfg.d_model), torch.bfloat16, gen)

    def fwd():
        with torch.no_grad():
            return moe.moe_apply(x, p, cfg, policy)

    def fwd_bwd():
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        xx = x.detach().requires_grad_()
        y, aux = moe.moe_apply(xx, leaves, cfg, policy)
        return torch.autograd.grad((y * cot).float().sum() + aux,
                                   [xx] + list(leaves.values()))

    iters = MOE["time_iters"]
    T, k, E = B * S, cfg.experts_per_token, cfg.num_experts
    cap = int(math.ceil(T * k / E * cfg.capacity_factor))
    flops = 3 * 2 * E * cap * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
    out = {"tokens": T, "capacity": cap, "expert_gemm_flops_fwd": flops,
           "fwd_ms": event_ms(fwd, iters), "fwd_bwd_ms": event_ms(fwd_bwd,
                                                                  iters)}
    out["fwd_tflops"] = flops / out["fwd_ms"] / 1e9
    out["fwd_bwd_tflops"] = 3 * flops / out["fwd_bwd_ms"] / 1e9
    return out


def moe_train_parity():
    """(e), single device: reduced kimi and llama4 (MoE FFNs, attention
    mixers) fp32 train loss and every grad leaf card vs host at 1e-4 (as
    tests/test_torch_train.py); reduced jamba's loss at 1e-4 and each
    sublayer's vector-Jacobian product on the same input (its fp32 forward
    amplifies a rounding past the pin end to end;
    tests/test_torch_model.py): the output at 1e-4, the grads within
    PARITY_TOL of each one's scale, since the SSD's fp32 kernel is itself
    pinned at 1e-4 to the plain form and the chunked form's backward at
    jamba's decays (exp of chunk cumsums in the hundreds) moves a grad by
    ~5e-4 absolute between two fp32 summation orders."""
    out = {}
    for arch in (KIMI, LLAMA4, JAMBA):
        cfg = reduced(get_config(arch))
        params = init_params(cfg, torch.Generator().manual_seed(17), "cpu")
        batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=24,
                                       global_batch=4, seed=0)).batch(0)
        loss_fn = build_loss_fn(cfg)
        card = {k: v.cuda() for k, v in params.items()}
        loss_g, met_g, grads_g = loss_and_grads(
            loss_fn, card, batch_to_device(batch, "cuda"))
        loss_c, met_c, grads_c = loss_and_grads(
            loss_fn, params, batch_to_device(batch, "cpu"))
        name = f"moe train parity fp32 {arch}"
        out[arch] = {"loss": [float(loss_g), float(loss_c)],
                     "aux": [float(met_g["aux"]), float(met_c["aux"])],
                     "loss_err": check_close(f"{name} loss", loss_g.cpu(),
                                             loss_c, MOE_TRAIN_TOL)}
        if arch != JAMBA:
            out[arch]["grad_err"] = max(
                check_close(f"{name} grad {k}", grads_g[k].cpu(), g,
                            MOE_TRAIN_TOL) for k, g in grads_c.items())
            continue
        S, B = 12, 2
        gen = torch.Generator().manual_seed(18)
        pos = torch.arange(S)[None, :].expand(B, S)
        x = params["embed"][torch.randint(0, cfg.vocab_size, (B, S),
                                          generator=gen)]
        worst = 0.0
        for i in range(cfg.num_layers):
            s, j = divmod(i, cfg.block_period)
            pre = f"blocks.pos{j}."
            p = {k[len(pre):]: v[s] for k, v in params.items()
                 if k.startswith(pre)}
            cot = torch.randn((B, S, cfg.d_model), generator=gen)
            res = {}
            for dev in ("cuda", "cpu"):
                leaves = {k: v.to(dev).requires_grad_() for k, v in p.items()}
                xx = x.to(dev).requires_grad_()
                y, _, aux = sublayer_apply(leaves, xx, cfg, j,
                                           positions=pos.to(dev),
                                           mode="train")
                roots, cots = [y], [cot.to(dev)]
                if aux.requires_grad:
                    roots, cots = roots + [aux], cots + [torch.ones((), device=dev)]
                gs = torch.autograd.grad(roots, [xx] + list(leaves.values()),
                                         cots, materialize_grads=True,
                                         allow_unused=True)
                res[dev] = (y.detach().cpu(), [g.cpu() for g in gs])
            check_close(f"{name} layer {i} y", res["cuda"][0],
                        res["cpu"][0], MOE_TRAIN_TOL)
            worst = max(worst, *(check_scaled(
                f"{name} layer {i} grad {k}", a, b, PARITY_TOL)
                for k, a, b in zip(["x"] + list(p), res["cuda"][1],
                                   res["cpu"][1])))
            x = res["cpu"][0]
        out[arch]["layer_err"] = worst
    return out


def moe_hybrid_rank(rank, world_mesh, *, mesh):
    """(e), the hybrid step: the ep-grads config of tests/md/test_moe_md.py
    (``MOE_HYBRID_CFG``) through ``build_hybrid_value_and_grad`` on the (dp, pp, cp, tp, ep)
    ``mesh``, fp32, M 2, against the single-device step (the microbatches'
    mean loss) on rank 0's card, at that file's pins; then, on a live ep
    axis, (f) the MoE sub-layer timed at ep = 4 (4 ranks)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(**MOE_HYBRID_CFG)
    dp, pp, cp, tp, ep = mesh
    m = launch_mesh.make_hybrid_mesh(dp, pp, cp, tp, ep, device="cuda")
    policy = Policy.for_mesh(m, explicit_tp=True)
    M, B, S = 2, 16, 16
    params = init_pipeline_params(cfg, torch.Generator().manual_seed(19), pp,
                                  "cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0)).batch(0)
    batch = batch_to_device(data, "cuda")
    card = {k: v.cuda() for k, v in params.items()}
    pvg, _ = build_hybrid_value_and_grad(cfg, policy, num_microbatches=M)
    loss, grads = pvg(card, {"tokens": batch["tokens"].reshape(M, B // M, S)},
                      batch["labels"].reshape(M, B // M, S))
    out = {"rank": rank, "mesh": list(mesh), "loss": float(loss)}
    if rank == 0:
        dense = {k: v.detach().requires_grad_()
                 for k, v in from_pipeline_params(card).items()}
        loss_fn = build_loss_fn(cfg)
        tok = batch["tokens"].reshape(M, B // M, S)
        lab = batch["labels"].reshape(M, B // M, S)
        ref_loss = sum(loss_fn(dense, {"tokens": tok[i], "labels": lab[i]})[0]
                       for i in range(M)) / M
        ref = dict(zip(dense, torch.autograd.grad(ref_loss,
                                                  list(dense.values()))))
        got = from_pipeline_params(grads)
        rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        bad = [k for k, g in got.items()
               if bool(((g - ref[k]).abs() > MOE_HYBRID_ATOL
                        + MOE_HYBRID_RTOL * ref[k].abs()).any())]
        out.update(ref_loss=float(ref_loss), loss_rel_err=rel, bad=bad,
                   grad_err=max(float((g - ref[k]).abs().max())
                                for k, g in got.items()))
        if rel > MOE_HYBRID_LOSS_RTOL or bad:
            raise AssertionError(f"moe hybrid {mesh}: loss rel {rel}, grads "
                                 f"off the pins: {bad}")
    if ep > 1 and tp == 1:
        pol = Policy.for_mesh(launch_mesh.make_host_mesh(
            (ep,), ("ep",), device="cuda"))
        out["sublayer_ep"] = {"ep": ep, **moe_sublayer_ms(jamba_cfg(), pol)}
    torch.distributed.barrier()
    return out


def phase_moe(smi):
    """Phase 12, ``moe``: (a) the kernels at jamba's shapes, (b) the MoE FFN
    at full width card vs host, (c) the served model layer by layer, (d)
    jamba-v0.1-52b served at full width cut to 8 layers, (f) the MoE
    sub-layer timed, (e) the MoE train path at small widths, single device
    and hybrid over NCCL.  Prints ``{"moe": ...}``; returns the launch
    counts of the serve run by path."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=60).stdout
    print(free, flush=True)
    res = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "free_g": free.splitlines()}
    moe_kernel_checks()
    moe_ffn_parity(smi)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = jamba_cfg()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    res["layer_parity"] = moe_layer_parity(cfg, params, smi)
    snap = moe_serve(cfg, params, smi)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["sublayer"] = {"ep": 1, "batch": MOE["time_batch"],
                       "seq": MOE["time_seq"], **moe_sublayer_ms(cfg)}
    emit(phase="moe_sublayer", arch=JAMBA, **res["sublayer"], nvidia_smi=smi)
    gc.collect()
    torch.cuda.empty_cache()
    res["train_parity"] = moe_train_parity()
    cards = torch.cuda.device_count()
    res["hybrid"] = {}
    for name, mesh in MOE_MESHES.items():
        world = math.prod(mesh)
        if world > cards:
            res["hybrid"][name] = {"skipped": f"mesh {mesh} needs {world} "
                                   f"cards, this machine has {cards}"}
            continue
        ranks = launch_mesh.spawn(functools.partial(moe_hybrid_rank,
                                                    mesh=mesh), world,
                                  device="cuda", timeout_s=600)
        if len({r["loss"] for r in ranks}) != 1:
            raise AssertionError(f"moe hybrid {mesh}: ranks disagree")
        res["hybrid"][name] = ranks[0]
        if "sublayer_ep" in ranks[0]:
            res["sublayer_ep4"] = ranks[0]["sublayer_ep"]
    if "sublayer_ep4" not in res:
        res["sublayer_ep4"] = {"skipped": f"ep 4 needs 4 cards, this machine "
                               f"has {cards}"}
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps({"moe": res}), flush=True)
    return {f"serve {JAMBA}": snap}


# ---------------------------------------------------------------------------
# Phase 13: context parallelism, the KVRingShift ring over the ctx axis.
# ---------------------------------------------------------------------------

def kimi_attention_parity(smi):
    """(0) kimi-k2-1t-a32b's attention sub-layer at full width (d_model
    7168, 64 heads of 112 over 8 KV heads), bf16 prefill on the card (one
    tensor-core flash launch at head dim 112) against the host's fp32 run
    from the same bf16-rounded parameters: output and K/V within
    BF16_PARITY_TOL of their scale; the card's forward timed.  Its MoE FFN
    (384 experts) does not fit one card and is left out."""
    cfg = dataclasses.replace(get_config(KIMI), dtype="bfloat16")
    B, S = KIMI_ATTN["batch"], KIMI_ATTN["seq"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    p = attn_init(cfg, torch.bfloat16, gen)
    x = randn((B, S, cfg.d_model), torch.bfloat16, gen)
    pos = torch.arange(S, device="cuda")[None, :].expand(B, S)

    def run():
        return attention_block(p, x, cfg, positions=pos, mode="prefill")

    ops.reset_launches()
    out_g, kv_g = run()
    torch.cuda.synchronize()
    snap = snapshot()
    want = {"flash_attention": 1, "rmsnorm": 0, "ssd_scan": 0}
    if (snap["launches"] != want
            or snap["routes"]["flash_attention"]["tensor_core"] != 1):
        raise AssertionError(f"kimi attention: launches {snap}")
    host = dataclasses.replace(cfg, dtype="float32")
    out_c, kv_c = attention_block(
        {k: v.float().cpu() for k, v in p.items()}, x.float().cpu(), host,
        positions=pos.cpu(), mode="prefill")
    errs = {"out": check_scaled(f"{KIMI} attention out bf16 card vs fp32 "
                                f"host", out_g.cpu(), out_c,
                                BF16_PARITY_TOL)}
    for name in ("k", "v"):
        errs[name] = check_scaled(f"{KIMI} attention {name} bf16 card vs "
                                  f"fp32 host", kv_g[name].cpu(),
                                  kv_c[name], BF16_PARITY_TOL)
    with torch.no_grad():
        ms = event_ms(run, 10)
    return {"arch": KIMI, "d_model": cfg.d_model, "heads": cfg.num_heads,
            "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
            "batch": B, "seq": S, "share_of_scale": errs, "launches": snap,
            "forward_ms": ms, "left_out": "the MoE FFN (384 experts of "
            "7168 x 2048) does not fit one card", "nvidia_smi": smi}


def virtual_ring(q, k, v, cp, chunk):
    """Attention over the whole sequence as ``cp`` virtual ranks of
    contiguous shards, each composed from ``ring_hop`` in the reference's
    hop order (hop t: rank r holds the shard of rank (r - t) % cp, the
    diagonal first) at the same global positions."""
    s = q.shape[1] // cp
    qs, ks, vs = (t.split(s, dim=1) for t in (q, k, v))
    outs = []
    for r in range(cp):
        carry = ring.ring_init(qs[r])
        for t in range(cp):
            src = (r - t) % cp
            carry = ring.ring_hop(carry, qs[r], ks[src], vs[src],
                                  q_pos0=r * s, kv_base=src * s, chunk=chunk)
        outs.append(ring.ring_finish(carry, q.dtype))
    return torch.cat(outs, dim=1)


def check_pinned(name, got, want, rtol, atol_share):
    """|got - want| <= atol_share * max |want| + rtol |want| everywhere:
    the reference's pins with the absolute one scaled by the magnitude of
    ``want``; returns the max abs error."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    err = (got - want).abs()
    bad = int((err > atol_share * scale + rtol * want.abs()).sum())
    emit(phase="check", case=name, max_abs_err=float(err.max()),
         scale=scale, rtol=rtol, atol=atol_share * scale, mismatches=bad)
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {bad} elements outside the pins")
    return float(err.max())


def ring_arithmetic(gen):
    """(a) The 4-virtual-rank ring at glm4-9b's attention widths against
    the plain ``blockwise_attention`` on the whole sequence: forward and
    the q/k/v vjp, fp32 (TF32 off) at the reference's pins scaled by the
    output's magnitude, bf16 within the bf16 pin of scale."""
    cfg = get_config(GLM)
    B, S, cp, chunk = RING["batch"], RING["seq"], RING["cp"], RING["chunk"]
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {"shape": f"q ({B},{S},{H},{hd}) k/v ({B},{S},{KH},{hd})",
           "cp": cp, "chunk": chunk}
    for dtype in (torch.float32, torch.bfloat16):
        qkv = [randn((B, S, n, hd), dtype, gen).requires_grad_()
               for n in (H, KH, KH)]
        g = randn((B, S, H, hd), dtype, gen)
        res = {}
        for name, fn in (
                ("ring", lambda q, k, v: virtual_ring(q, k, v, cp, chunk)),
                ("plain", lambda q, k, v: ref.blockwise_attention(
                    q, k, v, chunk=chunk))):
            y = fn(*qkv)
            res[name] = [y.detach(), *torch.autograd.grad(y, qkv, g)]
            del y
            torch.cuda.synchronize()
        errs = {}
        for i, part in enumerate(("out", "dq", "dk", "dv")):
            case = f"ring cp={cp} {part} {dtype} vs blockwise"
            if dtype == torch.bfloat16:
                errs[part] = check_scaled(case, res["ring"][i],
                                          res["plain"][i], FLASH_TOL[dtype])
            elif part == "out":
                errs[part] = check_pinned(case, res["ring"][i],
                                          res["plain"][i], RING_FWD_TOL,
                                          RING_FWD_TOL)
            else:
                errs[part] = check_pinned(case, res["ring"][i],
                                          res["plain"][i], RING_GRAD_RTOL,
                                          RING_GRAD_ATOL)
        out[str(dtype)] = errs
        del res, qkv, g
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ring_hop_timing(gen):
    """(b) One hop at glm4-9b's widths, B 4, Sq = Skv = 1024, bf16 (the
    diagonal block, whose work every hop does): forward and forward +
    backward by CUDA events, the flash kernel on the same block, and the
    hop's bound (the whole block's products, since no block is skipped,
    and the shards and running stats each moved once).  Then the peak
    memory of one virtual rank's four hops at (a)'s shape against
    ``attention_working_set_bytes(..., cp=4)``."""
    cfg = get_config(GLM)
    B, s, chunk = RING["hop_batch"], RING["hop_seq"], RING["chunk"]
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bf16 = torch.bfloat16
    q, k, v = (randn((B, s, n, hd), bf16, gen).requires_grad_()
               for n in (H, KH, KH))
    g = randn((B, s, H, hd), bf16, gen)

    def hop():
        return ring.ring_hop(ring.ring_init(q), q, k, v, q_pos0=0,
                             kv_base=0, chunk=chunk)

    def hop_fwd_bwd():
        y = ring.ring_finish(hop(), bf16)
        return torch.autograd.grad(y, (q, k, v), g)

    with torch.no_grad():
        fwd_ms = event_ms(hop, RING["iters"])
    fwd_bwd_ms = event_ms(hop_fwd_bwd, RING["iters"])
    qd, kd, vd = (t.detach() for t in (q, k, v))
    flash_ms = cuda_ms(lambda: ops.flash_attention(qd, kd, vd))
    # the whole block's products (no block is skipped); the shards read
    # once and the running stats m, l, acc (fp32) read and written
    stats = (2 * B * s * H + B * s * H * hd) * 4
    cost = {"bytes": 2 * (qd.numel() + kd.numel() + vd.numel()) + 2 * stats,
            "flops": 4 * B * H * hd * s * s}
    bound = card_bound(cost, bf16)
    out = {"shape": f"q ({B},{s},{H},{hd}) k/v ({B},{s},{KH},{hd}) bf16",
           "chunk": chunk, "forward_ms": fwd_ms,
           "forward_backward_ms": fwd_bwd_ms,
           "flash_causal_ms": flash_ms, "bytes": cost["bytes"],
           "flops": cost["flops"], "bound_ms": bound["bound_ms"],
           "bound_by": bound["bound_by"]}
    del q, k, v, g, qd, kd, vd
    gc.collect()
    torch.cuda.empty_cache()
    # one virtual rank's hops at (a)'s shape: its shards held, each
    # visiting shard received as a fresh copy, forward only
    Bm, S, cp = RING["batch"], RING["seq"], RING["cp"]
    full = [randn((Bm, S, n, hd), bf16, gen) for n in (H, KH, KH)]
    s_loc = S // cp
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r = cp - 1                       # the rank that keeps every block
    qr = full[0][:, r * s_loc:(r + 1) * s_loc].clone()
    with torch.no_grad():
        carry = ring.ring_init(qr)
        for t in range(cp):
            src = (r - t) % cp
            kc, vc = (x[:, src * s_loc:(src + 1) * s_loc].clone()
                      for x in full[1:])
            carry = ring.ring_hop(carry, qr, kc, vc, q_pos0=r * s_loc,
                                  kv_base=src * s_loc, chunk=chunk)
            del kc, vc
        o = ring.ring_finish(carry, bf16)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    model = ring.attention_working_set_bytes(Bm, S, H, hd, chunk=chunk,
                                             cp=cp, dtype_bytes=2)
    out["memory"] = {"shape": f"B {Bm} S {S} cp {cp}", "rank": r,
                     "measured_peak_bytes": measured,
                     "working_set_model_bytes": model,
                     "measured_over_model": measured / model,
                     "model_at_cp1_bytes": ring.attention_working_set_bytes(
                         Bm, S, H, hd, chunk=chunk, cp=1, dtype_bytes=2)}
    del full, qr, carry, o
    return out


def ctx_loss(params, batch, cfg):
    """The stage body's ctx path on one rank (``sublayer_apply`` with the
    ctx axis, as ``pipeline_stage_body`` calls it), with the embedding,
    final norm, head and loss of ``forward``."""
    x = params["embed"][batch["tokens"]].to(DTYPES[cfg.dtype])
    B, S = batch["tokens"].shape
    pos = (prim.axis_index("ctx") * S
           + torch.arange(S, device=x.device))[None, :].expand(B, S)
    blocks = {k[len("blocks."):]: v.unbind(0) for k, v in params.items()
              if k.startswith("blocks.")}
    for j in range(cfg.num_layers // cfg.block_period):
        p_blk = {k: v[j] for k, v in blocks.items()}
        for i in range(cfg.block_period):
            x, _, _ = sublayer_apply(subtree(p_blk, f"pos{i}"), x, cfg, i,
                                     positions=pos, mode="train",
                                     ctx_axis="ctx")
    logits = rmsnorm(x, params["norm_final"]) @ params["lm_head"]
    return cross_entropy(logits, batch["labels"])[0]



def ring_one_rank(rank, world_mesh):
    """(a, continued) ``ring_attention`` itself on a live one-rank ctx axis
    (one hop, no shift) against ``blockwise_attention``, fp32, at glm4-9b's
    heads; (c) the ctx train path on one rank (glm4-9b at full width cut
    to 2 layers, bf16): forward and backward with the counts set to 0 just
    before and read just after: no flash launch (the ring is plain torch,
    as in the reference), 2L + 1 RMSNorm launches; its loss against the
    flash path's (``build_loss_fn``) on the same batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = launch_mesh.make_host_mesh((1,), ("ctx",), device="cuda")
    cfg = get_config(GLM)
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(17)
    B, S, chunk = RING["ctx_batch"], RING["ctx_seq"], RING["chunk"]
    q, k, v = (randn((B, S, n, hd), torch.float32, gen) for n in (H, KH, KH))
    with prim.use_mesh(mesh):
        got = ring.ring_attention(q, k, v, "ctx", chunk=chunk)
    out = {"one_rank_ring_max_abs_err": check_pinned(
        "ring_attention on a one-rank ctx axis vs blockwise", got,
        ref.blockwise_attention(q, k, v, chunk=chunk), RING_FWD_TOL,
        RING_FWD_TOL)}
    del q, k, v, got
    tcfg = dataclasses.replace(cfg, num_layers=RING["ctx_layers"])
    params = init_params(tcfg, gen, "cuda")
    batch = batch_to_device(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
        seed=0)).batch(0), "cuda")
    leaves = {n: t.detach().requires_grad_() for n, t in params.items()}
    ops.reset_launches()
    with prim.use_mesh(mesh):
        loss = ctx_loss(leaves, batch, tcfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    snap = snapshot()
    want = {"flash_attention": 0, "rmsnorm": 2 * tcfg.num_layers + 1,
            "ssd_scan": 0}
    if snap["launches"] != want:
        raise AssertionError(f"ctx train path: launches {snap}, expected "
                             f"{want}")
    with torch.no_grad():
        flash_loss = float(build_loss_fn(tcfg)(params, batch)[0])
    loss = float(loss.detach())
    rel = abs(loss - flash_loss) / abs(flash_loss)
    if rel > FLASH_TOL[torch.bfloat16] or not all(
            bool(torch.isfinite(g_).all()) for g_ in grads):
        raise AssertionError(f"ctx train path: loss {loss} vs flash "
                             f"path {flash_loss}")
    out["ctx_train"] = {"arch": GLM, "layers": tcfg.num_layers,
                        "dtype": tcfg.dtype, "batch": B, "seq": S,
                        "loss": loss, "flash_path_loss": flash_loss,
                        "loss_rel_diff": rel, "launches": snap}
    return out


def ring_rank(rank, world_mesh, *, mesh):
    """(d) on this rank of the (dp, pp, cp, tp, ep) ``mesh``, one NCCL
    rank per card: ``hybrid_parity`` at B 2, S 2048, M 2, 1F1B (fp32
    glm4-9b cut to 2 layers against the single-device step on rank 0, the
    reference's pins and PARITY_TOL of each leaf's scale, the launches
    counted: no flash under ctx); then bf16 cut to 8 layers,
    B 4, S 4096, M 4, 5 steps through ``launch.train.train_hybrid_rank``
    with the counts set to 0 just before and read just after (no flash;
    RMSNorm by ``hybrid_launches``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp, pp, cp, tp, ep = mesh
    m = launch_mesh.make_hybrid_mesh(dp, pp, cp, tp, ep, device="cuda")
    policy = Policy.for_mesh(m, explicit_tp=tp > 1)
    out = {"rank": rank, "mesh": list(mesh),
           "coordinate": dict(zip(policy.axis_names, m.get_coordinate()))}
    t0 = time.perf_counter()
    snap, err, loss, loss_r = hybrid_parity(
        policy, RING_PARITY["batch"], RING_PARITY["seq"],
        RING_PARITY["micro"], ("1f1b",))["1f1b"]
    out["parity"] = {"loss": loss, "single_device_loss": loss_r,
                     "launches": snap, "seconds": time.perf_counter() - t0}
    if err:
        out["parity"].update(loss_rel_err=err.pop("loss"),
                             worst_grad_share=max(
                                 e["max_abs_err"] / max(e["scale"], 1e-30)
                                 for e in err.values()))
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(GLM),
                              num_layers=RING_TRAIN["layers"])
    B, S, M, steps = (RING_TRAIN[k] for k in ("batch", "seq", "micro",
                                              "steps"))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, hist, policy = launch_train.train_hybrid_rank(
        cfg, mesh, steps=steps, batch=B, seq=S, microbatches=M,
        lr=TRAIN["lr"], seed=0, device="cuda", logger=lambda line: None)
    torch.cuda.synchronize()
    snap = snapshot()
    secs = sorted(rec["sec"] for rec in hist[1:])
    median_s = (secs[(len(secs) - 1) // 2] + secs[len(secs) // 2]) / 2
    out["train"] = {
        "layers": cfg.num_layers, "dtype": cfg.dtype, "batch": B, "seq": S,
        "microbatches": M, "steps": steps,
        "losses": [rec["loss"] for rec in hist],
        "step_ms": [rec["sec"] * 1e3 for rec in hist],
        "median_step_ms_2_5": median_s * 1e3, "tokens_per_s": B * S / median_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": snap, "seconds": time.perf_counter() - t0}
    want = hybrid_launches(cfg, policy, lambda f, b: steps * (f + b), M)
    if (snap["launches"] != want or len(hist) != steps
            or any(not math.isfinite(r["loss"]) or r["skipped"]
                   for r in hist)):
        raise AssertionError(f"ring train {mesh}: {out['train']}, expected "
                             f"launches {want}")
    del state
    torch.distributed.barrier()
    return out


def ring_meshes(smi):
    """(d): each mesh of ``RING_MESHES`` where the machine has its cards;
    on fewer cards each records that it skipped and why."""
    cards = torch.cuda.device_count()
    out = {}
    for name, mesh in RING_MESHES.items():
        world = math.prod(mesh)
        if world > cards:
            out[name] = {"skipped": f"mesh {mesh} needs {world} cards, this "
                         f"machine has {cards}"}
            continue
        ranks = launch_mesh.spawn(functools.partial(ring_rank, mesh=mesh),
                                  world, device="cuda", timeout_s=900)
        for r in ranks:
            if (r["parity"]["loss"] != ranks[0]["parity"]["loss"]
                    or r["train"]["losses"] != ranks[0]["train"]["losses"]):
                raise AssertionError(f"ring {mesh}: rank {r['rank']} "
                                     f"disagrees")
        out[name] = {**ranks[0], "nvidia_smi": smi, "ranks": [
            {k: r[k] for k in ("rank", "coordinate")}
            | {"peak_mem_bytes": r["train"]["peak_mem_bytes"],
               "launches": r["train"]["launches"]["launches"]}
            for r in ranks]}
    return out


def phase_ring(smi):
    """Phase 13, ``ring``: (0) kimi's head-dim-112 attention sub-layer,
    (a) the virtual ring's arithmetic, (b) one hop timed and one rank's
    memory, (a, c) a one-rank ctx axis over NCCL, (d) the 4-card meshes.
    Prints ``{"ring": ...}``; returns the launch counts of the ctx train
    path (one rank) by path."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)
    res = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    res["kimi_attention"] = kimi_attention_parity(smi)
    gc.collect()
    torch.cuda.empty_cache()
    res["arithmetic"] = ring_arithmetic(gen)
    res["hop"] = ring_hop_timing(gen)
    gc.collect()
    torch.cuda.empty_cache()
    (one,) = launch_mesh.spawn(ring_one_rank, 1, device="cuda",
                               timeout_s=600)
    res["one_rank"] = one
    res["meshes"] = ring_meshes(smi)
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps({"ring": res}), flush=True)
    return {f"ring ctx train bf16 {GLM}": one["ctx_train"]["launches"]}


# ---------------------------------------------------------------------------
# Phase 14: checkpoints, fault injection and elastic recovery.
# ---------------------------------------------------------------------------

def free_pinned_host_memory():
    """Give the page-locked host blocks that torch caches after a
    checkpoint's snapshot back to the system (host RAM is 96 GB on the
    one-card machine, and each phase's snapshots are tens of GB)."""
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def disk_check(path, need, what):
    """Print the filesystem of ``path`` and its free bytes; raise when
    fewer than ``need`` are free (a checkpoint never skips for want of
    room)."""
    path.mkdir(parents=True, exist_ok=True)
    usage = shutil.disk_usage(path)
    fs = subprocess.run(["df", "-T", str(path)], capture_output=True,
                        text=True, timeout=60).stdout.splitlines()[-1]
    emit(phase="resilience_disk", what=what, path=str(path), df=fs,
         free_bytes=usage.free, need_bytes=need)
    if usage.free < need:
        raise AssertionError(f"{what}: {usage.free} bytes free under {path},"
                             f" {need} needed")


def state_bytes(state) -> int:
    _, leaves = ckpt_lib._tree_paths(state)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def state_diff(a, b) -> list:
    """Keys of the leaves of two state trees that differ in any bit."""
    ka, la = ckpt_lib._tree_paths(a)
    kb, lb = ckpt_lib._tree_paths(b)
    if ka != kb:
        return ["<keys>"]
    return [k for k, x, y in zip(ka, la, lb)
            if (not torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x != y)]


def io_rates():
    """The last save's and restore's times and rates (GB/s, 1e9 bytes)."""
    out = {}
    for part, stats in ckpt_lib.IO_STATS.items():
        out[part] = dict(stats)
        for key, secs in stats.items():
            if key.endswith("_s") and secs > 0:
                out[part][key[:-2] + "_gbps"] = stats["bytes"] / secs / 1e9
    return out


def resilience_roundtrip():
    """(a): phase 8's cell (glm4-9b at full width, 8 layers, bf16 params
    and fp32 AdamW moments, B 4, S 1024): 2 steps, ``save``, then
    ``restore_latest_verified`` onto the card beside the live state; the
    restored state bitwise the saved one; step 3 from each of the two
    (the same step run twice from the same state) bitwise equal in loss
    and every leaf.  Launch counts set to 0 just before and read after."""
    cfg = dataclasses.replace(get_config(GLM), num_layers=RESIL["layers_a"])
    B, S = RESIL["batch"], RESIL["seq"]
    opt = make_optimizer(cfg.optimizer, total_steps=TRAIN["steps"],
                         base_lr=TRAIN["lr"])
    step = build_train_step(dataclasses.replace(cfg, grad_accum=1), opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=0))
    d = CKPT_ROOT / "roundtrip"
    shutil.rmtree(d, ignore_errors=True)
    ops.reset_launches()
    state = init_train_state(cfg, init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), opt)
    for i in range(2):
        state, _ = step(state, data.batch(i))
    torch.cuda.synchronize()
    nbytes = state_bytes(state)
    disk_check(CKPT_ROOT, int(1.05 * nbytes), "(a) one checkpoint")
    t0 = time.perf_counter()
    ckpt_lib.save(str(d), 2, state, keep=1)
    save_s = time.perf_counter() - t0
    saved = io_rates()
    free_pinned_host_memory()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    restored, at, quarantined = ckpt_lib.restore_latest_verified(
        str(d), like=state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    loaded = io_rates()["restore"]
    differ_restored = state_diff(state, restored)
    live = {k: v.to("cpu") for k, v in state["params"].items()}   # step 2
    state, m_live = step(state, data.batch(2))
    restored, m_restored = step(restored, data.batch(2))
    torch.cuda.synchronize()
    snap = snapshot()
    differ_step3 = state_diff(state, restored)
    losses = [repr(float(m_live["loss"])), repr(float(m_restored["loss"]))]
    out = {"arch": GLM, "layers": cfg.num_layers, "cut": "depth 40 -> 8",
           "batch": B, "seq": S, "params": sum(
               p.numel() for p in state["params"].values()),
           "state_bytes": nbytes, "save_s": save_s, "save": saved["save"],
           "write": saved["write"], "restore_s": restore_s,
           "restore": loaded, "restored_step": at,
           "differ_restored": differ_restored, "step3_losses": losses,
           "differ_step3": differ_step3,
           "peak_mem_bytes_restore_and_step": torch.cuda.max_memory_allocated(),
           "launches": snap}
    del state, restored
    gc.collect()
    torch.cuda.empty_cache()
    out["served"], out["serve_launches"] = serve_from_checkpoint(cfg, d,
                                                                 live)
    served = out["served"]
    del live
    shutil.rmtree(d)
    gc.collect()
    torch.cuda.empty_cache()
    free_pinned_host_memory()
    if (at != 2 or quarantined or differ_restored or differ_step3
            or losses[0] != losses[1] or not served["tokens_equal"]
            or served["params_differ"] or not served["restored_line"]):
        raise AssertionError(f"resilience (a): {out}")
    want = {"flash_attention": 4 * cfg.num_layers,
            "rmsnorm": 4 * (2 * cfg.num_layers + 1), "ssd_scan": 0}
    if snap["launches"] != want:
        raise AssertionError(f"resilience (a): launches {snap}, expected "
                             f"{want}")
    return out


def serve_from_checkpoint(cfg, d, live):
    """(a)'s checkpoint served by ``launch.serve.main(["--ckpt-dir", d])``
    (its depth cut passed as ``cfg``), after (a)'s own launch counts are
    read: the restored params bitwise ``live`` (the step-2 params, kept on
    the host), and its greedy tokens equal to those of an engine on
    ``live`` with the CLI's prompt (``--seed 0``: drawn from seed 1).  No
    disk writes.  The counts are set to 0 just before the CLI's run and
    read just after it, before the comparison engine runs, and must be
    one request's (``expected_launches``).  Returns (result, the CLI
    run's counts)."""
    run = RESIL_SERVE
    said = io.StringIO()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        res = serve.main(["--ckpt-dir", str(d), "--device", "cuda",
                          "--batch", str(run["batch"]),
                          "--prompt-len", str(run["prompt_len"]), "--steps",
                          str(run["steps"])], cfg=cfg)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    served = snapshot()
    print(said.getvalue(), end="", flush=True)
    lines = said.getvalue().splitlines()
    got = res["engine"].params
    out = {**run, "cli_s": cli_s, "restored_line": [
        ln for ln in lines if ln.startswith("restored params from step")],
           "params_differ": [k for k in live
                             if not torch.equal(got[k].cpu(), live[k])],
           "tokens": res["tokens"][0].tolist()}
    tokens = res["tokens"]
    del res, got
    prompt = torch.randint(0, cfg.vocab_size,
                           (run["batch"], run["prompt_len"]),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1), device="cuda")
    params = {k: v.to("cuda") for k, v in live.items()}
    want = ServeEngine(cfg, params, max_seq=run["prompt_len"] + run["steps"]
                       + 8, batch_size=run["batch"]).generate(
        prompt, run["steps"]).cpu()
    out["tokens_equal"] = bool(torch.equal(tokens, want))
    del params
    want_launches = expected_launches(cfg, run["steps"])
    if served["launches"] != want_launches:
        raise AssertionError(f"serve from checkpoint: launches {served}, "
                             f"expected {want_launches}")
    return out, served


def resilience_chaos():
    """(b): glm4-9b's layer widths, 2 layers, a vocabulary of 8192
    (``RESIL``), through ``launch.train.train`` with ``--fault-plan
    poison=3,crash=4,corrupt=bitflip``, async saves every 2 steps, keep 2:
    step 3 skipped, the crash at 4 damaging step 4's checkpoint (which
    holds the skip),
    its quarantine, the restart from step 2 and a clean replay; final loss
    and every leaf bitwise the fault-free run's (run first, without
    checkpoints); launch counts set to 0 just before the faulted run and
    read just after: the layers' flash and 2L + 1 norms a step executed."""
    cfg = dataclasses.replace(get_config(GLM), num_layers=RESIL["layers_b"],
                              vocab_size=RESIL["vocab_b"])
    kw = dict(steps=RESIL["steps_b"], batch=RESIL["batch"],
              seq=RESIL["seq"], lr=TRAIN["lr"], seed=0, device="cuda")
    t0 = time.perf_counter()
    golden, ghist = launch_train.train(cfg, logger=lambda line: None, **kw)
    golden_s = time.perf_counter() - t0
    nbytes = state_bytes(golden)
    d = CKPT_ROOT / "chaos"
    shutil.rmtree(d, ignore_errors=True)
    disk_check(CKPT_ROOT, int(3.1 * nbytes),
               "(b) three checkpoints at once (keep 2 + one being written)")
    logs = []
    ops.reset_launches()
    t0 = time.perf_counter()
    state, hist = launch_train.train(
        cfg, ckpt_dir=str(d), ckpt_every=RESIL["ckpt_every"],
        keep=RESIL["keep"], fault_plan=RESIL["plan"], logger=logs.append,
        **kw)
    torch.cuda.synchronize()
    chaos_s = time.perf_counter() - t0
    snap = snapshot()
    rates = io_rates()
    differ = state_diff(state, golden)
    listing = sorted(os.listdir(d))
    out = {"arch": GLM, "layers": cfg.num_layers,
           "cut": f"depth 40 -> 2, vocabulary 151552 -> {cfg.vocab_size}",
           "batch": RESIL["batch"], "seq": RESIL["seq"],
           "steps": RESIL["steps_b"], "plan": RESIL["plan"],
           "ckpt_every": RESIL["ckpt_every"], "keep": RESIL["keep"],
           "params": sum(p.numel() for p in state["params"].values()),
           "state_bytes": nbytes, "golden_s": golden_s, "chaos_s": chaos_s,
           "steps_executed": [r["step"] for r in hist],
           "skipped": [r["skipped"] for r in hist],
           "final_loss": [repr(hist[-1]["loss"]), repr(ghist[-1]["loss"])],
           "differ": differ, "health": hist.health, "listing": listing,
           "last_io": rates, "launches": snap, "log": logs}
    del state, golden
    shutil.rmtree(d)
    gc.collect()
    torch.cuda.empty_cache()
    free_pinned_host_memory()
    health = hist.health
    if (differ or out["final_loss"][0] != out["final_loss"][1]
            or (health["restarts"], health["quarantined_checkpoints"],
                health["skipped_steps"]) != (1, 1, 1)
            or out["steps_executed"] != [0, 1, 2, 3, 2, 3, 4]):
        raise AssertionError(f"resilience (b): {out}")
    n = len(hist)
    want = {"flash_attention": cfg.num_layers * n,
            "rmsnorm": (2 * cfg.num_layers + 1) * n, "ssd_scan": 0}
    if snap["launches"] != want:
        raise AssertionError(f"resilience (b): launches {snap}, expected "
                             f"{want}")
    return out


def resilience_heal_rank(rank, kw):
    """(c)'s heal on this rank: (b)'s config at (2, 1, 1, 2, 1) through
    ``launch.train.train_hybrid_rank``, clean, then with checkpoints every
    2 steps and an ``OSError`` raised on rank ``fault_rank`` alone by its
    save of step ``fault_step`` (after its part of the save's
    collectives; ``save_async`` patched in this process).  The next step's
    guard all-reduce carries it to every rank over NCCL, every rank
    restarts once from the newest checkpoint; final loss and every
    parameter against the clean run's."""
    cfg = dataclasses.replace(get_config(GLM), num_layers=RESIL["layers_b"],
                              vocab_size=RESIL["vocab_b"])
    state, hist, _ = launch_train.train_hybrid_rank(
        cfg, RESIL_MESH["full"], logger=lambda line: None, **kw)
    clean = {"loss": repr(hist[-1]["loss"]),
             "params": {k: v.cpu() for k, v in state["params"].items()}}
    del state
    d = CKPT_ROOT / "heal"
    if rank == 0:
        shutil.rmtree(d, ignore_errors=True)
    torch.distributed.barrier()
    real = ckpt_lib.save_async

    def save_async(ckpt_dir, step, *a, **k):
        out = real(ckpt_dir, step, *a, **k)
        if step == RESIL_MESH["fault_step"] and not fired:
            fired.append(step)
            raise OSError(f"injected failed save of step {step} on rank "
                          f"{rank}")
        return out

    fired, logs = [], []
    if rank == RESIL_MESH["fault_rank"]:
        ckpt_lib.save_async = save_async
    try:
        state, hist, _ = launch_train.train_hybrid_rank(
            cfg, RESIL_MESH["full"], ckpt_dir=str(d),
            ckpt_every=RESIL_MESH["ckpt_every"], logger=logs.append, **kw)
    finally:
        ckpt_lib.save_async = real
    out = {"health": hist.health, "steps_executed": [r["step"] for r in hist],
           "failures": [ln for ln in logs if ln.startswith("failure")],
           "final_loss": [repr(hist[-1]["loss"]), clean["loss"]],
           "differ": [k for k, v in state["params"].items()
                      if not torch.equal(v.cpu(), clean["params"][k])]}
    del state
    torch.distributed.barrier()
    if rank == 0:
        shutil.rmtree(d)
    return out


def resilience_mesh_rank(rank, world_mesh):
    """(c) on this rank of 4 cards: the heal of a fault one rank alone
    sees (``resilience_heal_rank``); the clean run at (dp, pp, cp, tp, ep)
    = (2, 1, 1, 2, 1) through ``launch.train.train_hybrid_rank``, then the
    same run with ``--elastic``, checkpoints every 2 steps and a data-axis
    device loss at step 3: ranks 2-3 leave, ranks 0-1 re-form the world at
    (1, 1, 1, 2, 1) with virtual_dp 2, reshard step 2's checkpoint and
    finish; their final loss and every parameter against the clean run's
    (the same blocks on the same ranks)."""
    cfg = dataclasses.replace(get_config(GLM), num_layers=RESIL["layers_b"])
    kw = dict(steps=RESIL_MESH["steps"], batch=RESIL_MESH["batch"],
              seq=RESIL["seq"], microbatches=RESIL_MESH["micro"],
              lr=TRAIN["lr"], seed=0, device="cuda")
    heal = resilience_heal_rank(rank, kw)
    gc.collect()
    torch.cuda.empty_cache()
    state, hist, _ = launch_train.train_hybrid_rank(
        cfg, RESIL_MESH["full"], logger=lambda line: None, **kw)
    clean = {"loss": repr(hist[-1]["loss"]),
             "params": {k: v.cpu() for k, v in state["params"].items()}}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    d = CKPT_ROOT / "mesh"
    if rank == 0:      # two checkpoints: bf16 params, fp32 AdamW moments
        shutil.rmtree(d, ignore_errors=True)
        disk_check(CKPT_ROOT, int(2.1 * 10 * cfg.param_count()),
                   "(c) checkpoints")
    torch.distributed.barrier()
    logs = []
    t0 = time.perf_counter()
    state, hist, _ = launch_train.train_hybrid_rank(
        cfg, RESIL_MESH["full"], ckpt_dir=str(d),
        ckpt_every=RESIL_MESH["ckpt_every"], fault_plan=RESIL_MESH["plan"],
        elastic=True, logger=logs.append, **kw)
    out = {"rank": rank, "left": state is None, "health": hist.health,
           "seconds": time.perf_counter() - t0, "io": io_rates(),
           "steps_executed": [r["step"] for r in hist], "log": logs,
           "heal": heal}
    if state is None:
        return out
    out["final_loss"] = [repr(hist[-1]["loss"]), clean["loss"]]
    out["differ"] = [k for k, v in state["params"].items()
                     if not torch.equal(v.cpu(), clean["params"][k])]
    out["world"] = torch.distributed.get_world_size()
    torch.distributed.barrier()
    if rank == 0:
        shutil.rmtree(d)
    return out


def resilience_meshes(smi):
    """(c) where 4 cards exist; on fewer it records that it skipped."""
    cards = torch.cuda.device_count()
    world = math.prod(RESIL_MESH["full"])
    if world > cards:
        return {"skipped": f"mesh {RESIL_MESH['full']} needs {world} cards, "
                f"this machine has {cards}"}
    t0 = time.perf_counter()
    ranks = launch_mesh.spawn(resilience_mesh_rank, world, device="cuda",
                              timeout_s=900)
    out = {"nvidia_smi": smi, "mesh": RESIL_MESH, "ranks": ranks,
           "seconds": time.perf_counter() - t0}
    survivors = [r for r in ranks if not r["left"]]
    if ([r["rank"] for r in survivors] != [0, 1]
            or any(r["differ"] or r["final_loss"][0] != r["final_loss"][1]
                   or r["world"] != 2 or r["health"]["mesh_shrinks"] != 1
                   for r in survivors)):
        raise AssertionError(f"resilience (c): {out}")
    at = f"at step {RESIL_MESH['fault_step']})"
    if any(h["differ"] or h["final_loss"][0] != h["final_loss"][1]
           or h["health"]["restarts"] != 1 or len(h["failures"]) != 1
           or at not in h["failures"][0]
           for h in (r["heal"] for r in ranks)):
        raise AssertionError(f"resilience (c) heal: {out}")
    return out


def phase_resilience(smi):
    """Phase 14, ``resilience``: (a) the round trip at phase 8's cell, (b)
    the chaos heal at glm4-9b's layer widths, (c) the elastic shrink on 4 cards, each
    printed as one line ``{"resilience": {"part": ..., ...}}``; returns the
    launch counts of (a) and (b) by path."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    emit(phase="resilience_host", free=subprocess.run(
        ["free", "-g"], capture_output=True, text=True,
        timeout=60).stdout.splitlines())
    res = {}
    for part, run_part in (("a", resilience_roundtrip),
                           ("b", resilience_chaos),
                           ("c", functools.partial(resilience_meshes, smi))):
        t1 = time.perf_counter()
        res[part] = run_part()
        print(json.dumps({"resilience": {
            "part": part, "kind": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "seconds": time.perf_counter() - t1,
            **res[part]}}), flush=True)
    emit(phase="resilience", seconds=time.perf_counter() - t0)
    return {f"resilience roundtrip bf16 {GLM}": res["a"]["launches"],
            f"serve from checkpoint bf16 {GLM}": res["a"]["serve_launches"],
            f"resilience chaos bf16 {GLM}": res["b"]["launches"]}


# ---------------------------------------------------------------------------
# Phase 15: the stub frontends; phase 16: sharded serving.
# ---------------------------------------------------------------------------

@torch.inference_mode()
def embeds_prefill(engine, embeds):
    """The engine's prefill from ``{"embeds"}`` (its ``prefill`` takes
    tokens, as the reference's): the forward, then the prompt's K/V copied
    into the first positions of the engine's cache.  Returns (the last
    logits, the cache)."""
    cfg = engine.cfg
    B, S = embeds.shape[:2]
    logits, pref, _ = forward(engine.params, {"embeds": embeds}, cfg,
                              mode="prefill")
    cache = init_cache(cfg, B, engine.max_seq, device=embeds.device)
    for name, leaf in pref.items():
        cache[name][:, :, :S] = leaf
    return logits[:, -1], cache


@torch.inference_mode()
def embeds_generate(engine, embeds, steps):
    """Prefill from ``embeds``, then ``steps`` greedy decode steps; the
    prefill's and the decode's seconds, each ended by a synchronise."""
    S = embeds.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = embeds_prefill(engine, embeds)
    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = []
    for t in range(steps):
        out.append(tok)
        logits, cache = engine.decode_step(cache, tok, S + t)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    return (torch.cat(out, 1), t1 - t0, time.perf_counter() - t1,
            bool(finite))


def frontend_parity(arch, dtype):
    """``arch`` at full width cut to 2 layers, prefill from random embeds
    and 4 decode steps, card against host on the same parameters (the
    host in fp32 from the card's values): in fp32 the logits and caches
    within PARITY_TOL and the greedy tokens equal; in bf16 the prefill
    logits and caches within BF16_PARITY_TOL of scale and the first token
    equal, as phases 3's.  Returns the card's launch counts."""
    run = FRONTEND_PARITY
    cfg = dataclasses.replace(get_config(arch), num_layers=2, dtype=dtype)
    B, S = run["batch"], run["prompt_len"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = init_params(cfg, gen, "cuda")
    embeds = randn((B, S, cfg.d_model), DTYPES[dtype], gen)
    host_cfg = dataclasses.replace(cfg, dtype="float32")
    host = ServeEngine(host_cfg, {k: t.float().cpu()
                                  for k, t in params.items()},
                       max_seq=S + run["steps"] + 8, batch_size=B)
    card = ServeEngine(cfg, params, max_seq=S + run["steps"] + 8,
                       batch_size=B)
    ops.reset_launches()
    logits_g, cache_g = embeds_prefill(card, embeds)
    torch.cuda.synchronize()
    snap = snapshot()
    logits_c, cache_c = embeds_prefill(host, embeds.float().cpu())
    name = f"frontends parity {dtype} {arch}"
    if dtype == "float32":
        check_close(f"{name} prefill logits", logits_g.cpu(), logits_c,
                    PARITY_TOL)
        for key in cache_c:
            check_close(f"{name} cache {key}", cache_g[key].cpu(),
                        cache_c[key], PARITY_TOL)
        tok = logits_c.argmax(-1, keepdim=True)
        same = torch.equal(logits_g.argmax(-1, keepdim=True).cpu(), tok)
        for t in range(run["steps"]):
            logits_g, cache_g = card.decode_step(cache_g, tok.cuda(), S + t)
            logits_c, cache_c = host.decode_step(cache_c, tok, S + t)
            check_close(f"{name} decode {t} logits", logits_g.cpu(),
                        logits_c, PARITY_TOL)
            same &= torch.equal(logits_g.argmax(-1, keepdim=True).cpu(),
                                logits_c.argmax(-1, keepdim=True))
            tok = logits_c.argmax(-1, keepdim=True)
        expect_no_route(name, snap, "tensor_core")
    else:
        check_scaled(f"{name} prefill logits", logits_g.cpu(), logits_c,
                     BF16_PARITY_TOL)
        for key in cache_c:
            check_scaled(f"{name} cache {key}", cache_g[key].cpu(),
                         cache_c[key], BF16_PARITY_TOL)
        same = torch.equal(logits_g.float().argmax(-1).cpu(),
                           logits_c.argmax(-1))
        expect_no_route(name, snap, "tf32x3")
    emit(phase="frontends_parity", arch=arch, dtype=dtype, frontend=cfg.frontend,
         greedy_tokens_equal=bool(same), launches=snap)
    if not same:
        raise AssertionError(f"{name}: greedy tokens differ")
    return snap


def frontend_serve(arch, smi):
    """``arch`` in bf16 at its published widths: B 4 random embeds of 1024
    positions prefilled, then 32 greedy steps; a warm-up run of 2 steps
    first, the launch counts set to 0 just before the measured run and
    read just after (L flash launches on the tensor cores, (2L + 1) norms a
    forward)."""
    cfg = get_config(arch)
    run = FRONTENDS[arch]
    B, S, steps = run["batch"], run["prompt_len"], run["steps"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    params = init_params(cfg, gen, "cuda")
    n_params = sum(p.numel() for p in params.values())
    embeds = randn((B, S, cfg.d_model), torch.bfloat16, gen)
    engine = ServeEngine(cfg, params, max_seq=S + steps + 8, batch_size=B)
    embeds_generate(engine, embeds, 2)                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    tokens, prefill_s, decode_s, finite = embeds_generate(engine, embeds,
                                                          steps)
    snap = snapshot()
    out = {"arch": arch, "frontend": cfg.frontend, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "params": n_params, "dtype": "bfloat16",
           **run, "prefill_s": prefill_s, "decode_s": decode_s,
           "prefill_tok_s": B * S / prefill_s,
           "decode_tok_s": B * steps / decode_s,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": snap, "tokens": tokens[0].tolist(),
           "nvidia_smi": smi}
    emit(phase="frontends_serve", **out)
    want = {"flash_attention": cfg.num_layers,
            "rmsnorm": (2 * cfg.num_layers + 1) * (1 + steps),
            "ssd_scan": 0}
    if (not finite or snap["launches"] != want
            or snap["routes"]["flash_attention"]["tf32x3"]
            or tokens.shape != (B, steps)
            or int(tokens.max()) >= cfg.vocab_size):
        raise AssertionError(f"frontends {arch}: {out}, launches expected "
                             f"{want}")
    del engine, params
    return snap


def phase_frontends(smi):
    """Phase 15, ``frontends``: the bf16 flash kernel at musicgen-medium's
    head dim 64 and prefill shape against its plain version; each stub
    frontend's 2-layer parity, fp32 and bf16; each served at full width.
    Returns the launch counts by path."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = get_config(MUSICGEN)
    gen = torch.Generator(device="cuda").manual_seed(9)
    B, S = FRONTENDS[MUSICGEN]["batch"], FRONTENDS[MUSICGEN]["prompt_len"]
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = randn((B, S, H, hd), torch.bfloat16, gen)
    k = randn((B, S, KH, hd), torch.bfloat16, gen)
    v = randn((B, S, KH, hd), torch.bfloat16, gen)
    before = dict(ops.ROUTE_LAUNCHES["flash_attention"])
    got = ops.flash_attention(q, k, v, causal=True)
    expect_routes("flash_attention", torch.bfloat16, before)
    check_close(f"flash {MUSICGEN} hd {hd} B={B} S={S} H={H} bf16", got,
                ref.attention_ref(q, k, v, causal=True),
                FLASH_TOL[torch.bfloat16])
    del q, k, v, got
    by_path = {}
    for arch in (PIXTRAL, MUSICGEN):
        for dtype in ("float32", "bfloat16"):
            by_path[f"frontends parity {dtype} {arch}"] = frontend_parity(
                arch, dtype)
            gc.collect()
            torch.cuda.empty_cache()
        by_path[f"frontends bf16 {arch}"] = frontend_serve(arch, smi)
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="frontends", seconds=time.perf_counter() - t0)
    return by_path


def teacher_forced(engine, prompt, tokens):
    """The last logits of ``engine``'s prefill and of each decode step fed
    ``tokens`` (B, steps): (steps, B, V) in fp32 on the host."""
    S = prompt.shape[1]
    logits, cache = engine.prefill(prompt)
    out = [logits.float().cpu()]
    for t in range(tokens.shape[1] - 1):
        logits, cache = engine.decode_step(cache, tokens[:, t:t + 1], S + t)
        out.append(logits.float().cpu())
    return torch.stack(out)


@contextlib.contextmanager
def routed_moe(replay=None):
    """Under it, every MoE FFN call records its router logits (fp32) and
    its own top-k experts, on the host: ``(logits (T, E), experts (T,
    k))`` a call, in call order.  With ``replay``, such a recording of
    another run over the same tokens, each call routes to the recorded
    experts in place of its own top-k, its gates its own softmax at
    them."""
    plain = moe._dispatch_combine_local
    calls = []

    def routed(x, router_w, cfg, expert_fn, stat_axes=()):
        logits = x.float() @ router_w
        calls.append((logits.cpu(), torch.topk(
            logits, cfg.experts_per_token, dim=-1).indices.cpu()))
        if replay is None:
            return plain(x, router_w, cfg, expert_fn, stat_axes)
        forced = replay[len(calls) - 1][1].to(x.device)
        topk = torch.topk
        torch.topk = lambda probs, k, dim=-1: (probs.gather(-1, forced),
                                               forced)
        try:
            return plain(x, router_w, cfg, expert_fn, stat_axes)
        finally:
            torch.topk = topk

    moe._dispatch_combine_local = routed
    try:
        yield calls
    finally:
        moe._dispatch_combine_local = plain


def check_routes(name, got_calls, want_calls):
    """The routers of two runs over the same tokens, the reference
    (``want``) routed as the other (``routed_moe(replay=...)``): wherever
    the reference's own top-k differs from the other's, a near-tie: for
    every expert the reference would choose and the other did not, one
    the other chose instead lies within twice the two runs' largest
    router-logit error at the swapped experts, below it in the
    reference's logits, else it fails.  Returns the router logits' error
    as a share of their scale and the count of swaps."""
    if len(got_calls) != len(want_calls):
        raise AssertionError(f"{name}: {len(got_calls)} MoE calls against "
                             f"{len(want_calls)}")
    g = torch.cat([c[0] for c in got_calls])
    w = torch.cat([c[0] for c in want_calls])
    gi = torch.cat([c[1] for c in got_calls])
    wi = torch.cat([c[1] for c in want_calls])
    swaps = (gi.sort(-1).values != wi.sort(-1).values).any(-1)
    for t in swaps.nonzero()[:, 0].tolist():
        gs, ws = set(gi[t].tolist()), set(wi[t].tolist())
        swapped = list(gs ^ ws)
        err = float((g[t, swapped] - w[t, swapped]).abs().max())
        margin = max(min(float(w[t, e] - w[t, f]) for f in gs - ws)
                     for e in ws - gs)
        if margin > 2 * err:
            raise AssertionError(
                f"{name}: token {t} of the MoE calls routes to "
                f"{sorted(gs)} against the reference's {sorted(ws)}: "
                f"margin {margin} beyond twice the router-logit error "
                f"there, {err}")
    return {"router_share": float((g - w).abs().max() / w.abs().max()),
            "near_tie_swaps": int(swaps.sum()), "choices": int(gi.shape[0])}


def sharded_norm_arithmetic(x, w, eps):
    """``models.common.rmsnorm_sharded``'s arithmetic on a whole residual
    (the sum of squares over d, then the mean): at (data, model) = (1, 1)
    the sharded engine's norms compute exactly this, where the unsharded
    engine's launch the kernel."""
    xf = x.float()
    ss = (xf * xf).sum(-1, keepdim=True)
    return (xf * torch.rsqrt(ss / x.shape[-1] + eps) * w.float()).to(x.dtype)


@contextlib.contextmanager
def plain_norms():
    """Under it every norm of a forward computes
    ``sharded_norm_arithmetic`` in plain torch, not the kernel (no launch
    counted)."""
    kernel = ops._rmsnorm_fwd
    ops._rmsnorm_fwd = sharded_norm_arithmetic
    try:
        yield
    finally:
        ops._rmsnorm_fwd = kernel


def norm_swap_share(engine, prompt):
    """How far a model's own rounding carries: ``engine``'s prefill logits
    with the norm kernel against those with ``plain_norms`` (one bf16
    rounding apart at each norm), max |diff| over max |logit|."""
    a, _ = engine.prefill(prompt)
    with plain_norms():
        b, _ = engine.prefill(prompt)
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def routed_reference(name, engine, base, prompt, tokens, want=None,
                     reference=contextlib.nullcontext):
    """Teacher-forced logits (``teacher_forced``) of ``engine`` and of the
    reference engine ``base`` on ``tokens``, ``base`` run under the
    context ``reference()``: for an MoE model ``base`` runs routed as
    ``engine`` was (a token sent to another expert at a near-tie changes
    its FFN output by that output's size, and the residual carries it
    on), and ``check_routes`` holds the swaps to near-ties.  ``want``:
    ``base``'s logits, for a model with no MoE FFN (they do not depend
    on ``engine``).  Returns (got, want, the routers' check or None)."""
    if not engine.cfg.num_experts:
        return teacher_forced(engine, prompt, tokens), want, None
    with routed_moe() as routes:
        got = teacher_forced(engine, prompt, tokens)
    with routed_moe(replay=routes) as base_routes, reference():
        want = teacher_forced(base, prompt, tokens)
    return got, want, check_routes(name, routes, base_routes)


def held_to(name, got, want, got_tokens, want_tokens, tol, exact_tokens,
            hold=True):
    """Logits (steps, B, V), teacher-forced on the reference's greedy
    tokens, within ``tol`` of scale, and the greedy tokens equal.  With
    ``exact_tokens`` False (bf16), where two greedy runs may part at a
    near-tie, the tokens are held teacher-forced at every step and row
    instead: wherever the argmax of ``got`` is not that of ``want`` (the
    reference's token, or with its routing replayed, ``routed_reference``,
    the token it picks under that routing), that row's top-2 margin in
    ``want`` must lie within twice the error of ``got`` at those two
    entries, else it fails.  With ``hold`` False the same is measured
    and returned, not asserted (a model whose own rounding carries to the
    logits' scale, ``sublayer_shares`` holding it instead)."""
    got_f, want_f = got.float(), want.float()
    err = float((got_f - want_f).abs().max())
    scale = float(want_f.abs().max())
    share = err / max(scale, 1e-30)
    emit(phase="check", case=name, max_abs_err=err, scale=scale,
         share=share, tol=tol if hold else None)
    if hold and (share > tol or not torch.isfinite(got).all()):
        raise AssertionError(f"{name}: error {err} is {share:.4f} of the "
                             f"scale {scale}, above {tol}")
    got_tokens, want_tokens = got_tokens.cpu(), want_tokens.cpu()
    equal = bool(torch.equal(got_tokens, want_tokens))
    first = (None if equal else
             int((got_tokens != want_tokens).any(0).nonzero()[0]))
    if exact_tokens and not equal:
        raise AssertionError(f"{name}: greedy tokens differ first at step "
                             f"{first}")
    ties = []
    for t, b in (got.argmax(-1) != want.argmax(-1)).nonzero().tolist():
        top2 = torch.topk(want[t, b], 2).indices
        margin = float(want[t, b, top2[0]] - want[t, b, top2[1]])
        err = float((got[t, b, top2] - want[t, b, top2]).abs().max())
        ties.append({"step": t, "row": b, "margin": margin, "err": err})
        if hold and margin > 2 * err:
            raise AssertionError(f"{name}: teacher-forced token differs at "
                                 f"step {t}, row {b}: top-2 margin {margin} "
                                 f"beyond twice the error there, {err}")
    return {"share": share, "held": hold, "tokens_equal": equal,
            "first_differ": first, "teacher_forced_differ": len(ties),
            "ties": ties[:8]}


def sublayer_shares(name, cfg, params, mine, policy, prompt, max_seq, tol):
    """Each sublayer of ``cfg``'s prefill run on the same input by the
    sharded engine's body on this rank (its shards ``mine`` under
    ``policy``) and by the one-card engine's (``params``), the input the
    one-card prefill's own; an MoE FFN of the one-card engine routed as
    the sharded one was (``routed_moe``).  The update each adds to the
    residual, on this rank's feature block, within ``tol`` of its scale
    plus the bf16 rounding of the residual add on each side, else it
    fails; returns the largest error of each over its scale."""
    B, S = prompt.shape
    inputs = []
    plain = model_blocks.sublayer_apply

    def recording(p, x, *args, **kw):
        inputs.append(x)
        return plain(p, x, *args, **kw)

    model_blocks.sublayer_apply = recording
    try:
        with torch.inference_mode():
            forward(params, {"tokens": prompt}, cfg, mode="prefill")
    finally:
        model_blocks.sublayer_apply = plain
    with prim.use_mesh(policy.mesh):
        me = prim.axis_index(policy.model_axis)
    offs = shard_offsets(cfg.d_model, policy.model_size)
    cols = slice(offs[me], offs[me + 1])
    positions = torch.arange(S, device=prompt.device)[None].expand(B, S)
    cache = init_cache(cfg, B, max_seq, device=prompt.device, policy=policy)
    shares = []
    for j, x in enumerate(inputs):
        s, i = divmod(j, cfg.block_period)
        pre = f"blocks.pos{i}."
        p1, pm = ({k[len(pre):]: v[s] for k, v in tree.items()
                   if k.startswith(pre)} for tree in (params, mine))
        x_loc = x[..., cols].contiguous()
        with torch.inference_mode():
            with routed_moe() as routes, region(policy):
                y_loc = model_blocks._tp_sublayer_body(
                    pm, x_loc, positions, cfg, policy, cfg.ffn_kind(i),
                    mixer=cfg.mixer_kind(i), mode="prefill",
                    cache=subtree(cache, f"pos{i}"), index=s)
            with routed_moe(replay=routes):
                y, _, _ = sublayer_apply(p1, x, cfg, i, positions=positions,
                                         mode="prefill")
        want = (y - x)[..., cols].float()
        got = (y_loc - x_loc).float()
        err = (got - want).abs()
        shares.append(float(err.max() / want.abs().max()))
        # each side rounds x + update to bf16: up to 2^-8 of |y| apiece
        bound = tol * want.abs().max() + 2 ** -7 * y[..., cols].float().abs()
        if (err > bound).any():
            raise AssertionError(
                f"{name}: sublayer {j}'s update differs by {shares[-1]:.4f} "
                f"of its scale, beyond {tol} of it plus the residual's "
                f"rounding")
    emit(phase="check", case=f"{name} sublayers", share=max(shares), tol=tol)
    return shares


def decode_profile(engine, prompt, top=8):
    """One decode step after ``prompt``'s prefill under ``torch.profiler``
    (host and device activity): its wall ms (synchronised; the profiler's
    own cost included), the device kernels' self times summed over every
    stream (NCCL kernels' waiting included, so not a busy share of the
    wall), the collectives the step issued, and the ``top`` host ops by
    self CPU time."""
    from torch.profiler import ProfilerActivity, profile
    S = prompt.shape[1]
    with torch.inference_mode():
        logits, cache = engine.prefill(prompt)
        tok = logits.argmax(-1, keepdim=True)
        engine.decode_step(cache, tok, S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.decode_step(cache, tok, S + 1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sum(getattr(e, "self_device_time_total", 0) for e in events
                  if str(e.device_type).endswith("CUDA")) / 1e3
    host = sorted(events, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:top]
    return {"wall_ms": wall_ms, "kernel_ms_sum": kernels,
            "collectives": sum(e.count for e in events
                               if e.key.startswith("c10d::")),
            "host_top": [{"op": e.key, "count": e.count,
                          "self_cpu_ms": e.self_cpu_time_total / 1e3}
                         for e in host]}


def sharded_launches(cfg, steps):
    """Launches of one sharded request (prefill + ``steps`` decode steps):
    flash and the SSD scan once per layer of their kind in prefill, on
    this rank's heads; one RMSNorm a forward, the final norm, where the
    residual is whole (the others run over the feature-sharded residual,
    ``rmsnorm_sharded``)."""
    kinds = [cfg.mixer_kind(i) for i in range(cfg.num_layers)]
    return {"flash_attention": kinds.count("attn"), "rmsnorm": 1 + steps,
            "ssd_scan": kinds.count("ssm")}


def check_sharded_launches(name, cfg, snap, steps):
    """The measured request's launches are ``sharded_launches``, every
    flash and SSD launch on the tensor-core route (bf16)."""
    want = sharded_launches(cfg, steps)
    bad = snap["launches"] != want or any(
        snap["routes"][k]["tf32x3"] for k in ("flash_attention",
                                                 "ssd_scan"))
    if bad:
        raise AssertionError(f"{name}: launches {snap}, expected {want} on "
                             f"the tensor cores")


def serve_sharded_model(arch, mesh):
    """One model of phase 16 on this NCCL rank: ``arch`` in bf16 at full
    width (``SHARDED[arch]``'s depth) through ``ServeEngine`` with no
    policy (its rates with the norm kernel, and ``norm_swap_share``),
    then with a (data, model) = (1, 1) policy under each of its layouts
    on the same parameters (``shard_params``).  The reference is the
    unsharded engine with ``plain_norms``, the arithmetic of the sharded
    engine's norms: at random weights one bf16 rounding at each norm
    carries through mamba2-370m's 48 layers to the logits' scale
    (``norm_swap_share``, printed), so only the same arithmetic can be
    held.  The logits of
    the prefill and of every decode step fed its greedy tokens within
    BF16_PARITY_TOL of scale (an MoE model's reference routed as the
    sharded engine was, ``routed_reference``), and the tokens held to its
    at every step, teacher-forced (``held_to``); a warm-up request, then
    the measured one with the launch counts set to 0 just before and
    read just after (``sharded_launches``)."""
    run = SHARDED[arch]
    cfg = dataclasses.replace(get_config(arch), num_layers=run["layers"])
    B, S, steps = run["batch"], run["prompt_len"], run["steps"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = init_params(cfg, gen, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    base = ServeEngine(cfg, params, max_seq=S + steps + 8, batch_size=B)
    base.generate(prompt, 2)                             # warm-up
    base.generate(prompt, steps)
    out = {"arch": arch, "mesh": (1, 1), **run, "layouts": {},
           "params": sum(p.numel() for p in params.values()),
           "unsharded_prefill_tok_s": B * S / base.stats["prefill_s"],
           "unsharded_decode_tok_s": B * steps / base.stats["decode_s"],
           "unsharded_decode_profile": decode_profile(base, prompt),
           "norm_swap_share": norm_swap_share(base, prompt)}
    with plain_norms():
        want_tok = base.generate(prompt, steps)
        want = None if cfg.num_experts else teacher_forced(base, prompt,
                                                            want_tok)
    for layout in run["layouts"]:
        pol = Policy.for_mesh(mesh, kv_layout=layout)
        engine = ServeEngine(cfg, shard_params(cfg, params, pol), pol,
                             max_seq=S + steps + 8, batch_size=B)
        engine.generate(prompt, 2)                        # warm-up
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        got_tok = engine.generate(prompt, steps)
        snap = snapshot()
        st = engine.stats
        name = f"serve_sharded {layout} {arch}"
        got, want_l, routes = routed_reference(name, engine, base, prompt,
                                               want_tok, want, plain_norms)
        res = held_to(name, got, want_l, got_tok, want_tok,
                      BF16_PARITY_TOL, exact_tokens=False)
        res.update(prefill_tok_s=B * S / st["prefill_s"],
                   decode_tok_s=B * steps / st["decode_s"],
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   launches=snap, logits_finite=st["logits_finite"],
                   routing=routes,
                   decode_profile=decode_profile(engine, prompt))
        out["layouts"][layout] = res
        emit(phase="serve_sharded", arch=arch, layout=layout, **res)
        if not st["logits_finite"]:
            raise AssertionError(f"{name}: non-finite logits")
        check_sharded_launches(name, cfg, snap, steps)
        del engine
    return out


def serve_sharded_rank(rank, world_mesh):
    """Phase 16 on one NCCL rank: ``serve_sharded_model`` for each model
    of ``SHARDED``, the card's memory emptied between them."""
    mesh = launch_mesh.make_host_mesh((1, 1), ("data", "model"),
                                      device="cuda")
    out = {}
    for arch in SHARDED:
        out[arch] = serve_sharded_model(arch, mesh)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_serve_sharded(smi):
    """Phase 16, ``serve_sharded``: ``serve_sharded_rank`` spawned as one
    NCCL rank.  Prints ``{"serve_sharded": ...}``; returns the launch
    counts of each model's and layout's measured request by path."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (res,) = launch_mesh.spawn(serve_sharded_rank, 1, device="cuda",
                               timeout_s=900)
    res = {"models": res, "kind": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "seconds": time.perf_counter() - t0}
    print(json.dumps({"serve_sharded": res}), flush=True)
    return {f"serve_sharded {layout} bf16 {arch}": r["launches"]
            for arch, m in res["models"].items()
            for layout, r in m["layouts"].items()}


def mesh_cfg(arch, layers, dtype="bfloat16"):
    return dataclasses.replace(get_config(arch), num_layers=layers,
                               dtype=dtype)


def serve_mesh_parity(rank, arch, cfg, run, mesh_shape=SERVE_MESH):
    """This rank of (data, model) = ``mesh_shape`` ((1, 4) by default):
    ``arch`` at full width (``cfg``
    gives its depth and dtype), the global parameters drawn on every card
    from one seed; the one-card engine with no policy runs first and its
    results are kept on the host, then the sharded engine on this rank's
    cut (``shard_params``; in fp32 the global tree freed) under each
    layout: fp32 logits within PARITY_TOL of scale and greedy tokens
    equal; bf16 each sublayer's update within BF16_PARITY_TOL
    (``sublayer_shares``), and a dense model's logits within
    BF16_PARITY_TOL too (``held_to``), an MoE model's one-card engine
    routed as the sharded one was (``routed_reference``).  An SSM or MoE
    model's bf16 logits are measured, not held: at random weights its own
    rounding carries to their scale (``norm_swap_share``; PERF.md §6).  Returns each layout's result and the sharded engine's launches
    and rates, beside the one-card engine's ``norm_swap_share``."""
    B, S, steps = run["batch"], run["prompt_len"], run["steps"]
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = init_params(cfg, gen, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    base = ServeEngine(cfg, params, max_seq=S + steps + 8, batch_size=B)
    base.generate(prompt, 2)                             # warm-up
    want_tok = base.generate(prompt, steps)
    out = {"params": sum(p.numel() for p in params.values()),
           "layers": cfg.num_layers, "dtype": cfg.dtype, **run,
           "one_card_prefill_tok_s": B * S / base.stats["prefill_s"],
           "one_card_decode_tok_s": B * steps / base.stats["decode_s"],
           "norm_swap_share": norm_swap_share(base, prompt)}
    fp32 = cfg.dtype == "float32"
    dense = not any(cfg.mixer_kind(i) == "ssm" or cfg.ffn_kind(i) == "moe"
                    for i in range(cfg.block_period))
    want = (None if cfg.num_experts and not fp32 else
            teacher_forced(base, prompt, want_tok))
    mesh = launch_mesh.make_host_mesh(mesh_shape, ("data", "model"),
                                      device="cuda")
    mine = shard_params(cfg, params, Policy.for_mesh(mesh))
    if fp32:   # the one-card engine is done: free the global tree
        del base, params
        gc.collect()
        torch.cuda.empty_cache()
    for layout in LAYOUTS:
        pol = Policy.for_mesh(mesh, kv_layout=layout)
        engine = ServeEngine(cfg, mine, pol, max_seq=S + steps + 8,
                             batch_size=B)
        engine.generate(prompt, 2)                        # warm-up
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        got_tok = engine.generate(prompt, steps)
        snap = snapshot()
        st = engine.stats
        name = (f"serve_mesh {mesh_shape} {layout} {cfg.dtype} {arch} "
                f"{cfg.num_layers} layers rank {rank}")
        if fp32:
            got, want_l, routes = teacher_forced(engine, prompt,
                                                 want_tok), want, None
        else:
            got, want_l, routes = routed_reference(
                name, engine, base, prompt, want_tok, want)
        out[layout] = held_to(name, got, want_l, got_tok, want_tok,
                              PARITY_TOL if fp32 else BF16_PARITY_TOL,
                              exact_tokens=fp32, hold=fp32 or dense)
        if not fp32 and "sublayers" not in out:
            out["sublayers"] = sublayer_shares(
                name, cfg, params, mine, pol, prompt, S + steps + 8,
                BF16_PARITY_TOL)
        out[layout].update(
            launches=snap, tokens=got_tok[0].tolist(), routing=routes,
            prefill_tok_s=B * S / st["prefill_s"],
            decode_tok_s=B * steps / st["decode_s"],
            peak_mem_bytes=torch.cuda.max_memory_allocated())
        want_l = sharded_launches(cfg, steps)
        if snap["launches"] != want_l:
            raise AssertionError(f"{name}: launches {snap}, expected "
                                 f"{want_l}")
        expect_no_route(name, snap, "tensor_core" if fp32 else "tf32x3")
        if rank == 0:
            emit(phase="serve_mesh_parity", arch=arch, dtype=cfg.dtype,
                 layers=cfg.num_layers, layout=layout, **out[layout])
        del engine
    return out


def serve_mesh_full(rank, arch, cfg, smi, mesh_shape=SERVE_MESH,
                    run=SERVE_MESH_FULL, tally=False):
    """This rank of ``mesh_shape`` ((1, 4) by default): ``arch`` in bf16
    at full width and ``cfg``'s depth, this rank's shards drawn on its
    card alone (``init_rank_params``), ``run``'s batch, prompt and greedy
    steps (B 4, prompt 1024, 32 steps by default) under each layout: a
    warm-up request of 2 steps, then the measured one, its launch counts
    set to 0 just before and read just after (``sharded_launches``, on
    the tensor cores); with ``tally``, then one prefill and decode step
    measured as the dry run traces them (``serve_step_tally``)."""
    B, S, steps = run["batch"], run["prompt_len"], run["steps"]
    mesh = launch_mesh.make_host_mesh(mesh_shape, ("data", "model"),
                                      device="cuda")
    t0 = time.perf_counter()
    params = init_rank_params(cfg, Policy.for_mesh(mesh), seed=0,
                              device="cuda")
    torch.cuda.synchronize()
    out = {"layers": cfg.num_layers, "init_s": time.perf_counter() - t0,
           "rank_params": sum(p.numel() for p in params.values()),
           "rank_param_bytes": sum(p.numel() * p.element_size()
                                   for p in params.values()),
           "nvidia_smi": smi}
    prompt = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1), device="cuda")
    for layout in LAYOUTS:
        pol = Policy.for_mesh(mesh, kv_layout=layout)
        engine = ServeEngine(cfg, params, pol, max_seq=S + steps + 8,
                             batch_size=B)
        engine.generate(prompt, 2)                         # warm-up
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        tokens = engine.generate(prompt, steps)
        snap = snapshot()
        st = engine.stats
        out[layout] = {"prefill_s": st["prefill_s"],
                       "decode_s": st["decode_s"],
                       "prefill_tok_s": B * S / st["prefill_s"],
                       "decode_tok_s": B * steps / st["decode_s"],
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                       "launches": snap, "tokens": tokens[0].tolist(),
                       "logits_finite": st["logits_finite"],
                       "decode_profile": decode_profile(engine, prompt)}
        name = f"serve_mesh full {layout} {arch} rank {rank}"
        if tally:
            out[layout]["step"] = serve_step_tally(engine, prompt)
        if rank == 0:
            emit(phase="serve_mesh_full", arch=arch, layout=layout,
                 **{k: v for k, v in out.items() if k not in LAYOUTS},
                 **out[layout])
        if not st["logits_finite"]:
            raise AssertionError(f"{name}: non-finite logits")
        check_sharded_launches(name, cfg, snap, steps)
        del engine
    return out


def serve_step_tally(engine, prompt):
    """The sharded ``engine``'s prefill of ``prompt`` and the first decode
    step after it, as ``dryrun.mesh_cell(..., kind="serve")`` traces
    them: the card's peak memory over them (from what was allocated
    before, the rank's parameters), their kernel launches and their
    collectives by kind, count and bytes (``CollectiveTally``)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with CollectiveTally() as tally:
        logits, cache = engine.prefill(prompt)
        engine.decode_step(cache, logits.argmax(-1, keepdim=True),
                           prompt.shape[1])
        torch.cuda.synchronize()
    return {"peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": snapshot(),
            "collectives": {"counts": tally.counts, "bytes": tally.bytes}}


def serve_mesh_rank(rank, world_mesh, *, smi, cells):
    """The 4-card cells on this rank, the card's memory emptied between
    runs: each cell's full run (``serve_mesh_full``), then its parity cut
    in fp32 and bf16 (``serve_mesh_parity``); for ``glm4``, all 40 layers
    against one card in bf16.  Rank 0 prints each run's result as it
    ends."""
    out = {"rank": rank}
    for cell in cells:
        arch, parity_layers, layers, per_rank = SERVE_MESH_CELLS[cell]
        res = out[cell] = {"arch": arch, "parity": {}}
        if per_rank:
            res["full"] = serve_mesh_full(rank, arch, mesh_cfg(arch, layers),
                                          smi)
            gc.collect()
            torch.cuda.empty_cache()
        runs = ([(parity_layers, "float32", SERVE_MESH_PARITY),
                 (parity_layers, "bfloat16", SERVE_MESH_PARITY)]
                if parity_layers else [(layers, "bfloat16", SERVE_MESH_FULL)])
        for depth, dtype, run in runs:
            res["parity"][dtype] = serve_mesh_parity(
                rank, arch, mesh_cfg(arch, depth, dtype), run)
            gc.collect()
            torch.cuda.empty_cache()
    return out


def mesh_tokens(rank_out, cell):
    """One rank's first-row greedy tokens of ``cell``, by run and layout."""
    res = rank_out[cell]
    runs = {f"parity {dtype}": v for dtype, v in res["parity"].items()}
    if "full" in res:
        runs["full"] = res["full"]
    return {(name, layout): run[layout]["tokens"]
            for name, run in runs.items() for layout in LAYOUTS}


def serve_meshes(smi, cells=tuple(SERVE_MESH_CELLS)):
    """The 4-card cells of sharded serving (``tools/serve_phase_torch.py
    --four-card-meshes``), ``cells`` of ``SERVE_MESH_CELLS``, at (data,
    model) = (1, 4), one NCCL rank per card; on fewer cards it records
    that it skipped.  The ranks must agree on every greedy token."""
    cards = torch.cuda.device_count()
    world = math.prod(SERVE_MESH)
    if world > cards:
        return {"skipped": f"mesh {SERVE_MESH} needs {world} cards, this "
                f"machine has {cards}"}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch_mesh.spawn(
        functools.partial(serve_mesh_rank, smi=smi, cells=tuple(cells)),
        world, device="cuda", timeout_s=3000)
    for r in ranks:
        for cell in cells:
            if mesh_tokens(r, cell) != mesh_tokens(ranks[0], cell):
                raise AssertionError(f"serve_mesh {cell}: rank {r['rank']} "
                                     f"disagrees on the greedy tokens")
    return {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "mesh": SERVE_MESH, "cells": list(cells),
            "seconds": time.perf_counter() - t0, "ranks": ranks}


# ---------------------------------------------------------------------------
# Phase 19: the policy train program (ZeRO-3 over data, tensor and sequence
# parallelism over model), glm4-9b.
# ---------------------------------------------------------------------------

# (a) one card at mesh (1, 1): the 2-layer fp32 parity against the step
# without a policy, then 5 bf16 steps of 8 layers from init_params' cut
ZERO3 = {"parity_layers": 2, "parity_batch": 2, "parity_seq": 256,
         "layers": 8, "batch": 4, "seq": 1024, "steps": 5, "lr": 1e-3,
         "rank_init": False}
ZERO3_ONE_TOL = 1e-6      # (1, 1) against build_train_step with no policy
# (b) four cards: all 40 layers from the per-rank initialiser
ZERO3_FULL = {"layers": 40, "batch": 8, "seq": 1024, "steps": 5, "lr": 1e-3,
              "rank_init": True}
ZERO3_MESHES = {"dp4": ((4, 1), False), "dp2_tp2": ((2, 2), True)}
ZERO3_PEAK_TOL = 0.02     # the card's peak within 2% of the dry run's
CARD_BYTES = 80e9


class CollectiveTally:
    """A stand-in shape trace (``repro_torch.tracing``) that only counts the
    primitives' collectives and their output bytes by kind while it is
    active: the card's count of what the dry run predicts."""

    def __init__(self):
        self.counts, self.bytes = {}, {}

    def add(self, kind, op, ins, outs, **kw):
        if kind == "collective":
            self.counts[op] = self.counts.get(op, 0) + 1
            self.bytes[op] = self.bytes.get(op, 0) + kw["out_bytes"]

    def __enter__(self):
        tracing.TRACES.append(self)
        return self

    def __exit__(self, *exc):
        tracing.TRACES.remove(self)


class PhaseEvents:
    """``build_train_step``'s ``phase_hook``: a CUDA event as each part of
    the step starts; ``split()`` after a closing ``self("end")``."""

    def __init__(self):
        self.marks = []

    def __call__(self, kind):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((kind, ev))

    def split(self) -> dict:
        self.marks[-1][1].synchronize()
        out = {}
        for (kind, a), (_, b) in zip(self.marks, self.marks[1:]):
            out[f"{kind}_ms"] = out.get(f"{kind}_ms", 0.0) + a.elapsed_time(b)
        return out


def zero3_launches(cfg, steps, tp=1):
    """A step of the policy train program under remat: each superblock's
    forward runs again in the backward, so twice a layer's flash or SSD
    launch and its norms (one before each sublayer; an SSM mixer's gated
    norm too where the model axis has one rank, ``rmsnorm_sharded``
    otherwise), and once the final norm, outside the checkpoint: 2L flash
    and 4L + 1 norms for glm4-9b."""
    per = {"flash_attention": 0, "rmsnorm": 0, "ssd_scan": 0}
    for i in range(cfg.num_layers):
        mixer, ffn = cfg.mixer_kind(i), cfg.ffn_kind(i)
        per["flash_attention" if mixer == "attn" else "ssd_scan"] += 1
        per["rmsnorm"] += 1 + (ffn != "none") + (mixer == "ssm" and tp == 1)
    return {k: (2 * v + (k == "rmsnorm")) * steps for k, v in per.items()}


def zero3_parity(policy, tol, arch, cut):
    """``arch`` at full width cut to ``cut``'s parity layers (2), fp32:
    the policy step's loss and every gradient leaf (gathered from the
    blocks) against ``loss_and_grads`` of the loss without a policy on
    the same parameters (``init_params`` on this card, the same on every
    rank).  Returns the errors' shares of each leaf's scale and the
    launches."""
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=cut["parity_layers"],
                              dtype="float32")
    B, S = cut["parity_batch"], cut["parity_seq"]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(4),
                         "cuda")
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=0)).batch(0)
    opt = make_optimizer(cfg.optimizer, total_steps=5, base_lr=1e-3)
    loss1, _, want = loss_and_grads(build_loss_fn(cfg), params,
                                    batch_to_device(batch, "cuda"))
    got = {}

    def capture(g):
        if not got:
            got.update(g)
        return g

    ops.reset_launches()
    state = init_train_state(cfg, shard_train_params(cfg, params, policy),
                             opt)
    del params
    _, met = build_train_step(cfg, opt, policy=policy,
                              fault_hook=capture)(state, batch)
    torch.cuda.synchronize()
    snap = snapshot()
    specs = train_param_specs(cfg, policy)
    shares = {}
    with torch.no_grad():
        for k in sorted(want):
            full = linop.assemble(got.pop(k), specs[k], policy.mesh).float()
            ref_k = want.pop(k).float()
            shares[k] = float((full - ref_k).abs().max()
                              / ref_k.abs().max().clamp(min=1e-30))
    loss_share = abs(float(met["loss"]) - float(loss1)) / abs(float(loss1))
    out = {"arch": arch, "layers": cfg.num_layers, "batch": B, "seq": S,
           "tol": tol,
           "loss": float(met["loss"]), "loss_one_device": float(loss1),
           "loss_share": loss_share, "max_grad_share": max(shares.values()),
           "grad_shares": shares, "launches": snap}
    if loss_share > tol or max(shares.values()) > tol:
        raise AssertionError(f"zero3 parity at {tuple(policy.mesh.shape)}: "
                             f"loss {loss_share}, grads "
                             f"{max(shares.items(), key=lambda kv: kv[1])}")
    return out


def zero3_rank(rank, world_mesh, *, mesh_shape, parity, run, parity_tol):
    """Phase 19 (and 20 (b)) on this rank of the (data, model)
    ``mesh_shape``, ``run["arch"]`` (glm4-9b where absent): the fp32
    parity (``parity``), then ``run``'s bf16 steps through
    ``launch.train.train(..., mesh=)`` with the launch counts, and one
    more step split by CUDA events, its collectives tallied and its peak
    memory read."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = launch_mesh.make_host_mesh(mesh_shape, device="cuda",
                                   all_ranks_group=True)
    policy = Policy(m)
    out = {"rank": rank,
           "coordinate": dict(zip(policy.axis_names, m.get_coordinate()))}
    t0 = time.perf_counter()
    arch = run.get("arch", GLM)
    if parity:
        out["parity"] = zero3_parity(policy, parity_tol, arch,
                                     {**ZERO3, **run})
    out["parity_seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(arch), num_layers=run["layers"])
    B, S, steps = run["batch"], run["seq"], run["steps"]
    logs = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, hist = launch_train.train(
        cfg, steps=steps, batch=B, seq=S, lr=run["lr"], seed=0,
        device="cuda", mesh=mesh_shape, rank_init=run["rank_init"],
        logger=logs.append)
    torch.cuda.synchronize()
    snap = snapshot()
    train_s = time.perf_counter() - t0
    peak_run = torch.cuda.max_memory_allocated()
    secs = sorted(rec["sec"] for rec in hist[1:])
    median_s = (secs[(len(secs) - 1) // 2] + secs[len(secs) // 2]) / 2
    leaves = list(state["params"].values()) + [
        t for part in ("m", "v") for t in state["opt"][part].values()]
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    opt = make_optimizer(cfg.optimizer, total_steps=steps, base_lr=run["lr"])
    timer = PhaseEvents()
    step = build_train_step(cfg, opt, policy=policy, phase_hook=timer)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                   global_batch=B, seed=0)).batch(steps)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with CollectiveTally() as tally:
        _, met = step(state, batch)
        timer("end")
    split = timer.split()
    torch.cuda.synchronize()
    depth = get_config(arch).num_layers
    out["train"] = {
        "arch": arch, "layers": cfg.num_layers,
        "cut": ("none" if cfg.num_layers == depth
                else f"depth {depth} -> {cfg.num_layers}"),
        "dtype": cfg.dtype, "mesh": list(mesh_shape), "batch": B, "seq": S,
        "steps": steps, "rank_init": run["rank_init"],
        "params_on_rank": sum(p.numel() for p in state["params"].values()),
        "state_bytes_on_rank": state_bytes,
        "losses": [rec["loss"] for rec in hist],
        "grad_norms": [rec["grad_norm"] for rec in hist],
        "skipped": [rec["skipped"] for rec in hist],
        "step_ms": [rec["sec"] * 1e3 for rec in hist],
        "median_step_ms_2_5": median_s * 1e3,
        "tokens_per_s": B * S / median_s, "peak_mem_bytes_run": peak_run,
        "launches": snap, "seconds": train_s, "log": logs,
        "split": split, "split_step_loss": float(met["loss"]),
        "split_step_peak_bytes": torch.cuda.max_memory_allocated(),
        "split_step_launches": snapshot(),
        "collectives_a_step": {"counts": tally.counts,
                               "bytes": tally.bytes}}
    bad = (len(hist) != steps or met["skipped"]
           or any(not math.isfinite(r["loss"]) or r["skipped"]
                  for r in hist))
    if bad:
        raise AssertionError(f"zero3 train {mesh_shape}: "
                             f"{out['train']['losses']}, skipped "
                             f"{out['train']['skipped']}")
    want = zero3_launches(cfg, steps, mesh_shape[1])
    routes = {k: {"tensor_core": want[k], "tf32x3": 0}
              for k in ("flash_attention", "ssd_scan")}
    if snap["launches"] != want or any(snap["routes"][k] != r
                                       for k, r in routes.items()):
        raise AssertionError(f"zero3 train {mesh_shape}: launches {snap}, "
                             f"expected {want}, routes {routes}")
    if peak_run >= CARD_BYTES:
        raise AssertionError(f"zero3 train {mesh_shape}: peak {peak_run} B")
    return out


def zero3_spawn(smi, name, mesh_shape, parity, run, parity_tol):
    """One mesh of phase 19: ``zero3_rank`` on one NCCL rank per card;
    every rank's losses must agree.  Returns (rank 0's results with each
    rank's train summary, the launch counts summed over the ranks)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch_mesh.spawn(
        functools.partial(zero3_rank, mesh_shape=mesh_shape, parity=parity,
                          run=run, parity_tol=parity_tol),
        math.prod(mesh_shape), device="cuda", timeout_s=1200)
    res = ranks[0]
    for r in ranks:
        if r["train"]["losses"] != res["train"]["losses"]:
            raise AssertionError(f"zero3 {name}: rank {r['rank']} disagrees")
    res["ranks"] = [{"rank": r["rank"], "coordinate": r["coordinate"],
                     "peak_mem_bytes_run": r["train"]["peak_mem_bytes_run"],
                     "split_step_peak_bytes":
                         r["train"]["split_step_peak_bytes"],
                     "split_step_launches": r["train"]["split_step_launches"],
                     "state_bytes_on_rank": r["train"]["state_bytes_on_rank"],
                     "split": r["train"]["split"],
                     "collectives_a_step": r["train"]["collectives_a_step"]}
                    for r in ranks]
    res.update(name=name, world=len(ranks), backend="nccl",
               kind=torch.cuda.get_device_name(0), nvidia_smi=smi,
               seconds=time.perf_counter() - t0)
    total = {"launches": {}, "routes": {}}
    for r in ranks:
        for k, v in r["train"]["launches"]["launches"].items():
            total["launches"][k] = total["launches"].get(k, 0) + v
        for k, rs in r["train"]["launches"]["routes"].items():
            mine = total["routes"].setdefault(k, {})
            for route, v in rs.items():
                mine[route] = mine.get(route, 0) + v
    return res, total


def zero3_meshes(smi):
    """Phase 19 (b), four cards: glm4-9b at all 40 layers from the
    per-rank initialiser at (data, model) = (4, 1) and (2, 2), and at
    (2, 2) first the 2-layer fp32 parity against one card's step (the
    train parity's pin).  Each mesh's rank-0 peak of one step held within
    ZERO3_PEAK_TOL of the dry run's prediction (``launch.dryrun.
    mesh_cell``, traced here after the card ran the mesh), its kernel
    calls equal to the card's launches."""
    out, paths = {}, {}
    for name, (shape, parity) in ZERO3_MESHES.items():
        res, paths[f"zero3 bf16 {name} {GLM}"] = zero3_spawn(
            smi, name, shape, parity, ZERO3_FULL, PARITY_TOL)
        run = ZERO3_FULL
        pred = dryrun.mesh_cell(GLM, run["layers"], run["batch"],
                                run["seq"], shape)
        peak = pred["memory"]["peak_per_device_GiB"] * 2**30
        card = res["train"]["split_step_peak_bytes"]
        calls = {k: v for k, v in res["train"]["split_step_launches"]
                 ["launches"].items() if v}
        res["dryrun"] = {"predicted_peak_bytes": peak,
                         "card_peak_bytes": card, "peak_ratio": peak / card,
                         "kernel_calls": pred["kernel_calls"],
                         "card_launches_a_step": calls,
                         "collectives": pred["collectives"],
                         "roofline": pred["roofline"],
                         "trace_s": pred["trace_s"]}
        out[name] = res
        print(json.dumps({"zero3_mesh": res}), flush=True)
        if pred["kernel_calls"] != calls:
            raise AssertionError(f"zero3 {name}: dry run calls "
                                 f"{pred['kernel_calls']}, card {calls}")
        if abs(peak / card - 1) > ZERO3_PEAK_TOL:
            raise AssertionError(f"zero3 {name}: predicted peak {peak} B, "
                                 f"card {card} B")
    return out, paths


def phase_zero3(smi):
    """Phase 19, ``zero3``: (a) one NCCL rank at mesh (1, 1); (b) the
    four-card meshes where four cards exist (``zero3_meshes``).  Prints
    ``{"zero3": ...}``; returns the launch counts by path."""
    res, total = zero3_spawn(smi, "one_card", (1, 1), True, ZERO3,
                             ZERO3_ONE_TOL)
    print(json.dumps({"zero3": res}), flush=True)
    paths = {f"zero3 bf16 (1, 1) {GLM}": total,
             f"zero3 parity fp32 (1, 1) {GLM}": res["parity"]["launches"]}
    if torch.cuda.device_count() >= 4:
        paths.update(zero3_meshes(smi)[1])
    return paths


# ---------------------------------------------------------------------------
# Phase 20: query heads the model axis does not divide, split by the paper's
# balanced decomposition (``models.attention.head_block``).
# ---------------------------------------------------------------------------

PHI3, PHI4 = "phi3-medium-14b", "phi4-mini-3.8b"
# (a) the four archs whose query heads the reference's sweep's model axis
# (16) does not divide: 40, 40, 24 and 24
UNEVEN_ARCHS = (LLAMA4, PHI3, PHI4, MUSICGEN)
UNEVEN_TP = 16
UNEVEN_ATTN = {"batch": 4, "seq": 1024}
# (b) three cards: phi3-medium-14b at (data, model) = (1, 3), 14, 13 and 13
# query heads; every leaf whole (5120, 1280, 17920 and 100352 do not divide
# by 3); the 2-layer fp32 parity, then 5 bf16 steps of 8 layers from the
# per-rank initialiser (the sequence divisible by 3)
UNEVEN_MESH = (1, 3)
UNEVEN = {"arch": PHI3, "parity_layers": 2, "parity_batch": 2,
          "parity_seq": 258, "layers": 8, "batch": 4, "seq": 1536,
          "steps": 5, "lr": 1e-3, "rank_init": True}


def uneven_shapes(arch, tp=UNEVEN_TP) -> dict:
    """``{(query heads, K/V heads): [ranks]}`` of ``arch`` over a
    ``tp``-way model axis: each rank's block of the balanced head split
    and the K/V heads ``local_kv_heads`` lays out for it."""
    cfg = get_config(arch)
    out = {}
    for r in range(tp):
        n = head_block(cfg.num_heads, tp, r)[1]
        out.setdefault((n, len(local_kv_heads(cfg, tp, r))), []).append(r)
    return out


def uneven_kernel_checks():
    """(a): the bf16 flash kernel at every per-rank shape of the four archs
    at TP 16 (``flash_rank_rows``)."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    return flash_rank_rows(gen, UNEVEN_ARCHS, UNEVEN_TP,
                           "uneven_heads_kernel")


def flash_rank_rows(gen, archs, tp, phase):
    """The bf16 flash kernel at every per-rank shape of ``archs`` over a
    ``tp``-way model axis (B 4, S 1024, causal, K/V as
    ``_kv_of_local_heads`` lays them out) against its plain version at
    phase 2's bf16 pin; each timed beside its plain version, SDPA and its
    bound, one ``phase`` line a shape."""
    B, S = UNEVEN_ATTN["batch"], UNEVEN_ATTN["seq"]
    dtype = torch.bfloat16
    rows = []
    for arch in archs:
        hd = get_config(arch).resolved_head_dim
        for (h, kh), ranks in sorted(uneven_shapes(arch, tp).items(),
                                     reverse=True):
            q, k, v = (randn((B, S, n, hd), dtype, gen) for n in (h, kh, kh))
            before = dict(ops.ROUTE_LAUNCHES["flash_attention"])
            got = ops.flash_attention(q, k, v, causal=True)
            expect_routes("flash_attention", dtype, before)
            torch.cuda.synchronize()
            shape = (f"q ({B},{S},{h},{hd}) k/v ({B},{S},{kh},{hd}) "
                     f"causal")
            err = check_close(f"flash {arch} ranks {ranks} {shape} bf16",
                              got, ref.attention_ref(q, k, v, causal=True),
                              FLASH_TOL[dtype])
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            bound = card_bound(kernel_cost("flash_attention", q.shape,
                                           k.shape, v.shape, dtype=dtype),
                               dtype, ROUTES[dtype])
            row = dict(
                arch=arch, ranks=ranks, shape=shape, route=ROUTES[dtype],
                max_abs_err=err,
                ms=cuda_ms(lambda: ops.flash_attention(q, k, v)),
                plain_ms=cuda_ms(lambda: ref.attention_ref(q, k, v),
                                 iters=5),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
            emit(phase=phase, **row)
            rows.append(row)
    return rows


def uneven_mesh(smi):
    """(b), three cards or more: phi3-medium-14b at (1, 3) on three NCCL
    ranks (``zero3_spawn``): the 2-layer fp32 parity against one card's
    step at PARITY_TOL, then 5 bf16 steps of 8 layers from the per-rank
    initialiser, every rank's losses equal and finite.  Each rank's peak
    of one step held within ZERO3_PEAK_TOL of ``launch.dryrun.mesh_cell``
    traced as that rank, its launches equal to the traced kernel calls
    and its collectives a step to the traced ones, by count and bytes.
    Returns (the results, the launch counts by path)."""
    run = UNEVEN
    res, total = zero3_spawn(smi, "phi3_1x3", UNEVEN_MESH, True, run,
                             PARITY_TOL)
    cfg = get_config(PHI3)
    preds, held = {}, []
    for r in res["ranks"]:
        me = r["coordinate"]["model"]
        key = (head_block(cfg.num_heads, UNEVEN_MESH[1], me)[1],
               len(local_kv_heads(cfg, UNEVEN_MESH[1], me)))
        if key not in preds:
            preds[key] = dryrun.mesh_cell(PHI3, run["layers"], run["batch"],
                                          run["seq"], UNEVEN_MESH, rank=me)
        pred = preds[key]
        peak = pred["memory"]["peak_per_device_GiB"] * 2**30
        card = r["split_step_peak_bytes"]
        coll = {k: pred["collectives"][k] for k in ("counts", "bytes")}
        calls = {k: v for k, v in r["split_step_launches"]["launches"].items()
                 if v}
        held.append({"rank": r["rank"], "query_heads": key[0],
                     "kv_heads_attended": key[1],
                     "predicted_peak_bytes": peak, "card_peak_bytes": card,
                     "peak_ratio": peak / card,
                     "kernel_calls": pred["kernel_calls"],
                     "card_launches_a_step": calls,
                     "collectives": coll,
                     "card_collectives": r["collectives_a_step"],
                     "roofline": pred["roofline"],
                     "trace_s": pred["trace_s"]})
        if pred["kernel_calls"] != calls:
            raise AssertionError(f"uneven heads rank {r['rank']}: dry run "
                                 f"calls {pred['kernel_calls']}, card {calls}")
        if coll != r["collectives_a_step"]:
            raise AssertionError(f"uneven heads rank {r['rank']}: dry run "
                                 f"collectives {coll}, card "
                                 f"{r['collectives_a_step']}")
        if abs(peak / card - 1) > ZERO3_PEAK_TOL:
            raise AssertionError(f"uneven heads rank {r['rank']}: predicted "
                                 f"peak {peak} B, card {card} B")
    res["dryrun"] = held
    paths = {f"uneven heads bf16 {UNEVEN_MESH} {PHI3}": total,
             f"uneven heads parity fp32 {UNEVEN_MESH} {PHI3}":
                 res["parity"]["launches"]}
    return res, paths


def phase_uneven_heads(smi):
    """Phase 20, ``uneven_heads``: (a) the flash kernel at every 16-way
    rank shape of the four archs on one card; (b) phi3-medium-14b at
    (1, 3) where three cards exist (``uneven_mesh``).  Prints
    ``{"uneven_heads": ...}``; returns the launch counts by path."""
    t0 = time.perf_counter()
    out = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "tp": UNEVEN_TP, "kernels": uneven_kernel_checks()}
    paths = {}
    if torch.cuda.device_count() >= math.prod(UNEVEN_MESH):
        out["mesh"], paths = uneven_mesh(smi)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"uneven_heads": out}), flush=True)
    return paths


# ---------------------------------------------------------------------------
# Phase 21: widths the model axis does not divide (d_model, head_dim, d_ff,
# the SSM heads and d_inner), split by the paper's balanced decomposition
# (``core.partition.balanced_split``; heads by ``head_block``).
# ---------------------------------------------------------------------------

# (1, 3): glm4-9b's d_model 4096 (1366, 1365, 1365), 32 query heads (11,
# 11, 10), head_dim 128 under kvdim (43, 43, 42) and d_ff 13696 (4566,
# 4565, 4565), both K/V heads whole; mamba2-370m's 32 SSM heads (11, 11,
# 10) and their d_inner channels (704, 704, 640)
WIDTHS_MESH = (1, 3)
WIDTHS_SSD = {"batch": 8, "seq": 2048, "chunk": 64}     # mamba2's prefill
# (b) serving: each arch at all its layers (SERVE's batch, prompt and
# steps) from the per-rank initialiser and against one card, and cut to 2
# layers in fp32 against one card
WIDTHS_SERVE = {GLM: 40, MAMBA: 48}
# (c) training: mamba2-370m at all 48 layers from the per-rank initialiser
# (every SSM leaf whole over model, the sequence 683, 683, 682 a rank)
WIDTHS_TRAIN = {"arch": MAMBA, "parity_layers": 2, "parity_batch": 2,
                "parity_seq": 256, "layers": 48, "batch": 8, "seq": 2048,
                "steps": 5, "lr": 1e-3, "rank_init": True}
WIDTHS_PEAK_TOL = 0.02    # each rank's peak within 2% of the dry run's


def widths_kernel_checks():
    """(a): the bf16 flash kernel at glm4-9b's per-rank shapes at TP 3
    (``flash_rank_rows``: 11 query heads over one K/V head, 11 over one
    each, 10 over one) and the bf16 SSD scan at mamba2-370m's 11 and 10
    heads a rank (B 8, S 2048, P 64, N 128, chunk 64, dt and A drawn as
    its block makes them) against their plain versions at phase 2's bf16
    pins, each timed beside its plain version (and SDPA) and its bound."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    tp, bf16 = WIDTHS_MESH[1], torch.bfloat16
    rows = flash_rank_rows(gen, (GLM,), tp, "uneven_widths_kernel")
    cfg = get_config(MAMBA)
    B, S, L = WIDTHS_SSD["batch"], WIDTHS_SSD["seq"], WIDTHS_SSD["chunk"]
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    heads = {}
    for r in range(tp):
        heads.setdefault(head_block(cfg.ssm_heads, tp, r)[1], []).append(r)
    for H, ranks in sorted(heads.items(), reverse=True):
        args = ssd_inputs(B, S, H, P, N, bf16, gen, model=True)
        before = dict(ops.ROUTE_LAUNCHES["ssd_scan"])
        y, h = ops.ssd_scan(*args, chunk=L)
        expect_routes("ssd_scan", bf16, before)
        want_y, want_h = ref.ssd_chunked(*args, chunk=L)
        shape = f"x ({B},{S},{H},{P}) B/C ({B},{S},{N}) chunk {L}"
        err = check_close(f"ssd {MAMBA} ranks {ranks} {shape} bf16 y", y,
                          want_y, SSD_TOL[bf16])
        err = max(err, check_close(f"ssd {MAMBA} ranks {ranks} {shape} "
                                   f"h_final", h, want_h,
                                   SSD_TOL[torch.float32]))
        bound = card_bound(kernel_cost("ssd_scan", *(t.shape for t in args),
                                       dtype=bf16, chunk=L), bf16)
        row = dict(arch=MAMBA, ranks=ranks, shape=shape, route=ROUTES[bf16],
                   max_abs_err=err,
                   ms=cuda_ms(lambda: ops.ssd_scan(*args, chunk=L),
                              iters=10),
                   plain_ms=cuda_ms(lambda: ref.ssd_chunked(*args, chunk=L),
                                    iters=3),
                   library_ms=None, bound_ms=bound["bound_ms"],
                   bound_by=bound["bound_by"])
        emit(phase="uneven_widths_kernel", **row)
        rows.append(row)
    return rows


def widths_serve_rank(rank, world_mesh, *, smi):
    """(b) on this rank of (1, 3), each arch of WIDTHS_SERVE, the card's
    memory emptied between runs: its full run from the per-rank
    initialiser with the prefill and first decode step measured as the
    dry run traces them (``serve_mesh_full(..., tally=True)``), then
    against one card: cut to 2 layers in fp32 and at all its layers in
    bf16 (``serve_mesh_parity``)."""
    out = {"rank": rank}
    for arch, layers in WIDTHS_SERVE.items():
        res = out[arch] = {"parity": {}}
        res["full"] = serve_mesh_full(rank, arch, mesh_cfg(arch, layers), smi,
                                      WIDTHS_MESH, SERVE[arch], tally=True)
        gc.collect()
        torch.cuda.empty_cache()
        for depth, dtype, run in ((2, "float32", SERVE_MESH_PARITY),
                                  (layers, "bfloat16", SERVE[arch])):
            res["parity"][dtype] = serve_mesh_parity(
                rank, arch, mesh_cfg(arch, depth, dtype), run, WIDTHS_MESH)
            gc.collect()
            torch.cuda.empty_cache()
    return out


def widths_traces(cells):
    """``dryrun.mesh_cell(**kw)`` for each ``{key: kw}`` of ``cells``, each
    in a process of its own (a fake world each), all at once: the host
    traces, on ``meta``, what the cards ran.  Returns ``{key: result}``."""
    import concurrent.futures
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(len(cells), 8), mp_context=ctx) as pool:
        futures = {key: pool.submit(dryrun.mesh_cell, **kw)
                   for key, kw in cells.items()}
        return {key: f.result() for key, f in futures.items()}


def held_to_trace(name, pred, peak, launches, collectives):
    """A rank's card measurement against ``dryrun.mesh_cell``'s trace of
    it: the kernel calls and the collectives (count and bytes) equal, the
    peak within WIDTHS_PEAK_TOL.  Returns the comparison."""
    pred_peak = pred["memory"]["peak_per_device_GiB"] * 2**30
    calls = {k: v for k, v in launches["launches"].items() if v}
    coll = {k: pred["collectives"][k] for k in ("counts", "bytes")}
    out = {"predicted_peak_bytes": pred_peak, "card_peak_bytes": peak,
           "peak_ratio": pred_peak / peak,
           "kernel_calls": pred["kernel_calls"], "card_launches": calls,
           "collectives": coll, "card_collectives": collectives,
           "roofline": pred["roofline"], "trace_s": pred["trace_s"]}
    emit(phase="uneven_widths_dryrun", case=name,
         **{k: v for k, v in out.items() if k != "roofline"})
    if pred["kernel_calls"] != calls:
        raise AssertionError(f"{name}: dry run calls {pred['kernel_calls']},"
                             f" card {calls}")
    if coll != collectives:
        raise AssertionError(f"{name}: dry run collectives {coll}, card "
                             f"{collectives}")
    if abs(pred_peak / peak - 1) > WIDTHS_PEAK_TOL:
        raise AssertionError(f"{name}: predicted peak {pred_peak} B, card "
                             f"{peak} B")
    return out


def widths_mesh(smi):
    """(b) and (c), three cards or more: serving (``widths_serve_rank``)
    on three NCCL ranks, every rank's greedy tokens equal; training
    (``zero3_spawn``, mamba2-370m at (1, 3): the 2-layer fp32 parity
    against one card's step, then 5 bf16 steps of 48 layers from the
    per-rank initialiser, every rank's losses equal and finite); then each
    rank of each serving layout and of training held to
    ``dryrun.mesh_cell`` traced as that rank (``held_to_trace``).
    Returns (the results, the launch counts by path)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch_mesh.spawn(functools.partial(widths_serve_rank, smi=smi),
                              math.prod(WIDTHS_MESH), device="cuda",
                              timeout_s=1800)
    for r in ranks:
        for arch in WIDTHS_SERVE:
            if mesh_tokens(r, arch) != mesh_tokens(ranks[0], arch):
                raise AssertionError(f"uneven widths {arch}: rank "
                                     f"{r['rank']} disagrees on the greedy "
                                     f"tokens")
    serve_s = time.perf_counter() - t0
    train, total = zero3_spawn(smi, "mamba2_1x3", WIDTHS_MESH, True,
                               WIDTHS_TRAIN, PARITY_TOL)
    run = WIDTHS_TRAIN
    cells = {("train", r): dict(arch=MAMBA, layers=run["layers"],
                                batch=run["batch"], seq=run["seq"],
                                mesh_shape=WIDTHS_MESH, rank=r)
             for r in range(WIDTHS_MESH[1])}
    for arch, layers in WIDTHS_SERVE.items():
        sv = SERVE[arch]
        for layout in LAYOUTS:
            for r in range(WIDTHS_MESH[1]):
                cells[(arch, layout, r)] = dict(
                    arch=arch, layers=layers, batch=sv["batch"],
                    seq=sv["prompt_len"], mesh_shape=WIDTHS_MESH, rank=r,
                    kind="serve", kv_layout=layout,
                    max_seq=sv["prompt_len"] + sv["steps"] + 8)
    t1 = time.perf_counter()
    preds = widths_traces(cells)
    held = {"trace_wall_s": time.perf_counter() - t1, "train": [],
            "serve": []}
    for r in train["ranks"]:
        me = r["coordinate"]["model"]
        held["train"].append(held_to_trace(
            f"uneven widths train rank {me}", preds[("train", me)],
            r["split_step_peak_bytes"], r["split_step_launches"],
            r["collectives_a_step"]))
    for r in ranks:
        for arch in WIDTHS_SERVE:
            for layout in LAYOUTS:
                step = r[arch]["full"][layout]["step"]
                held["serve"].append(held_to_trace(
                    f"uneven widths serve {arch} {layout} rank {r['rank']}",
                    preds[(arch, layout, r["rank"])], step["peak_bytes"],
                    step["launches"], step["collectives"]))
    res = {"serve": ranks, "serve_s": serve_s, "train": train,
           "dryrun": held, "seconds": time.perf_counter() - t0}
    paths = {f"uneven widths train bf16 {WIDTHS_MESH} {MAMBA}": total,
             f"uneven widths train parity fp32 {WIDTHS_MESH} {MAMBA}":
                 train["parity"]["launches"]}
    for arch in WIDTHS_SERVE:
        for layout in LAYOUTS:
            paths[f"uneven widths serve {layout} {WIDTHS_MESH} {arch}"] = \
                ranks[0][arch]["full"][layout]["launches"]
            for dtype, run in ranks[0][arch]["parity"].items():
                paths[f"uneven widths serve parity {dtype} {layout} "
                      f"{WIDTHS_MESH} {arch}"] = run[layout]["launches"]
    return res, paths


def phase_uneven_widths(smi, out_path=None):
    """Phase 21, ``uneven_widths``: (a) the flash and SSD kernels at the
    per-rank shapes TP 3 gives glm4-9b and mamba2-370m, on one card; (b)
    and (c) where three cards exist (``widths_mesh``).  Prints
    ``{"uneven_widths": ...}``, and writes it to ``out_path`` if given;
    returns the launch counts by path."""
    t0 = time.perf_counter()
    out = {"kind": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "mesh": WIDTHS_MESH, "kernels": widths_kernel_checks()}
    paths = {}
    if torch.cuda.device_count() >= math.prod(WIDTHS_MESH):
        out["cards"], paths = widths_mesh(smi)
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps({"uneven_widths": out})
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(line + "\n")
    print(line, flush=True)
    return paths


def main():
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    by_path = {}
    for arch in (GLM, MAMBA):
        by_path[f"parity fp32 {arch}"] = phase_parity(arch)
        by_path[f"parity bf16 {arch}"] = phase_parity_bf16(arch)
        by_path[f"serve {arch}"] = phase_serve(arch, smi)
        phase_decode_share(arch, smi)
    phase_backward(rows)
    by_path[f"train parity fp32 {GLM}"] = phase_train_parity()
    cells = {}
    for arch in (GLM, MAMBA):
        by_path[f"train bf16 {arch}"], cells[f"train {arch}"] = \
            phase_train(smi, arch)
    phase_dryrun(smi, cells)
    phase_dist(smi)
    by_path.update(phase_region(smi))
    by_path.update(phase_hybrid(smi))
    by_path.update(phase_moe(smi))
    by_path.update(phase_ring(smi))
    by_path.update(phase_resilience(smi))
    by_path.update(phase_frontends(smi))
    by_path.update(phase_serve_sharded(smi))
    by_path.update(phase_zero3(smi))
    by_path.update(phase_uneven_heads(smi))
    by_path.update(phase_uneven_widths(smi))
    counted = {   # row -> (kernel, route) counted for it; None: all routes
        "flash_attention": ("flash_attention", "tensor_core"),
        "flash_attention_fp32": ("flash_attention", "tf32x3"),
        "rmsnorm": ("rmsnorm", None),
        "ssd_scan": ("ssd_scan", "tensor_core"),
        "ssd_scan_fp32": ("ssd_scan", "tf32x3"),
    }

    def launches_of(row, snap):
        name, route = counted[row["name"]]
        return (snap["launches"][name] if route is None
                else snap["routes"][name][route])

    for row in rows:
        row["launches_by_path"] = {path: launches_of(row, snap)
                                   for path, snap in by_path.items()
                                   if launches_of(row, snap)}
        row["path"] = ", ".join(row["launches_by_path"])
        row["launches"] = sum(row["launches_by_path"].values())
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on any path")
    keys = ("name", "route", "impl", "dtype", "cores", "source", "replaces",
            "tpu", "path", "launches", "launches_by_path", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops",
            "gbps", "backward", "backward_ms", "backward_max_abs_err")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

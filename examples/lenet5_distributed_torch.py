"""The paper's §5 experiment on the PyTorch port: distributed LeNet-5 ≡
sequential LeNet-5 (the port of ``examples/lenet5_distributed.py``).

Trains both networks from identical initializations on a synthetic
MNIST-shaped task and reports the paper's comparison: matching accuracies
and loss trajectories, and the paper's Table 1 for the partition.  One
process per rank (``launch.mesh.spawn``): NCCL with one rank per card for
``--device cuda`` (the default; too few cards raise), gloo for ``cpu``.
Every rank runs both networks on the same global values; the distributed
one as one region over the (fo, fi) mesh.

Run:  python examples/lenet5_distributed_torch.py [--device cpu]
          [--mesh 2,2] [--steps 60] [--batch 64]
"""

import argparse
import functools
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.models.lenet import (  # noqa: E402
    lenet_apply_distributed, lenet_apply_sequential, lenet_init,
    synthetic_mnist, table1_local_shapes)

LR = 0.05
FWD_PIN, GRAD_PIN = 2e-4, 2e-3     # tests/md/test_lenet_md.py
ACC_PIN = 0.02                     # examples/lenet5_distributed.py


def _xent(logits, y):
    return F.cross_entropy(logits, y)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step(apply, params, x, y):
    """One SGD step: (loss, new params)."""
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = _xent(apply(p, x), y)
    grads = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), {k: (v - LR * g).detach()
                         for (k, v), g in zip(p.items(), grads)}


def _excess(got, want, pin) -> tuple:
    """(max |got - want|, max of |got - want| - pin |want|): the pin holds,
    as ``assert_allclose(rtol=atol=pin)``, when the second is <= pin."""
    err = (got - want).abs()
    return float(err.max()), float((err - pin * want.abs()).max())


def _check_init(mesh, params, x, y) -> dict:
    """Distributed vs sequential at the initial parameters: the logits at
    the forward pin and every grad leaf at the grad pin."""
    pd = {k: v.clone().requires_grad_() for k, v in params.items()}
    ps = {k: v.clone().requires_grad_() for k, v in params.items()}
    ld, ls = (lenet_apply_distributed(mesh, pd, x),
              lenet_apply_sequential(ps, x))
    fwd = _excess(ld.detach(), ls.detach(), FWD_PIN)
    gd = torch.autograd.grad(_xent(ld, y), list(pd.values()))
    gs = torch.autograd.grad(_xent(ls, y), list(ps.values()))
    grads = [_excess(a, b, GRAD_PIN) for a, b in zip(gd, gs)]
    return {"fwd_max_abs_err": fwd[0], "grad_max_abs_err": max(
        g[0] for g in grads), "within_pins": fwd[1] <= FWD_PIN and all(
        g[1] <= GRAD_PIN for g in grads)}


def _rank(rank, world_mesh, *, shape, device, steps, batch):
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = launch_mesh.make_host_mesh(shape, ("fo", "fi"), device=device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params_d = lenet_init(gen)
    params_s = dict(params_d)                       # identical init
    xtr, ytr = synthetic_mnist(torch.Generator(device=dev).manual_seed(1),
                               4096)
    xte, yte = synthetic_mnist(torch.Generator(device=dev).manual_seed(2),
                               1024)
    check = _check_init(mesh, params_d, xtr[:batch], ytr[:batch])
    dist_step = functools.partial(lenet_apply_distributed, mesh)
    times = {"dist": [], "seq": []}
    losses = {"dist": [], "seq": []}
    for i in range(steps):
        lo = (i * batch) % (xtr.shape[0] - batch)
        xb, yb = xtr[lo:lo + batch], ytr[lo:lo + batch]
        for name, apply in (("dist", dist_step),
                            ("seq", lenet_apply_sequential)):
            _sync(dev)
            t0 = time.perf_counter()
            params = params_d if name == "dist" else params_s
            loss, params = _step(apply, params, xb, yb)
            _sync(dev)
            times[name].append(time.perf_counter() - t0)
            losses[name].append(loss)
            if name == "dist":
                params_d = params
            else:
                params_s = params
        if rank == 0 and i % 10 == 0:
            print(f" step {i:3d}  dist loss {losses['dist'][-1]:.4f}  "
                  f"seq loss {losses['seq'][-1]:.4f}  |Δ| "
                  f"{abs(losses['dist'][-1] - losses['seq'][-1]):.2e}",
                  flush=True)
    with torch.no_grad():
        acc_d = float((lenet_apply_distributed(mesh, params_d, xte)
                       .argmax(-1) == yte).float().mean())
        acc_s = float((lenet_apply_sequential(params_s, xte).argmax(-1)
                       == yte).float().mean())

    def ms(ts):
        ts = sorted(ts[1:] or ts)
        return 1e3 * (ts[(len(ts) - 1) // 2] + ts[len(ts) // 2]) / 2

    return {"mesh": list(shape), "device": str(dev), "steps": steps,
            "batch": batch, "losses": losses, "acc_dist": acc_d,
            "acc_seq": acc_s, "ms_per_step_dist": ms(times["dist"]),
            "ms_per_step_seq": ms(times["seq"]), **check}


def main(argv=None) -> dict:
    """Run the experiment; returns rank 0's results.  Raises when the
    distributed and sequential nets disagree."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mesh", default="2,2",
                    help="(fo, fi) mesh shape: one rank each")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.mesh.split(","))
    print("paper Table 1 per-worker affine shapes:",
          table1_local_shapes(shape), flush=True)
    res = launch_mesh.spawn(
        functools.partial(_rank, shape=shape, device=args.device,
                          steps=args.steps, batch=args.batch),
        math.prod(shape), device=args.device, timeout_s=900)[0]
    print(f"\ninit: logits differ by {res['fwd_max_abs_err']:.2e} (pin "
          f"{FWD_PIN}), grads by {res['grad_max_abs_err']:.2e} (pin "
          f"{GRAD_PIN})")
    print(f"test accuracy: distributed {res['acc_dist']:.2%}  sequential "
          f"{res['acc_seq']:.2%} (paper §5: 98.55% vs 98.54%)")
    print(f"ms a step: distributed {res['ms_per_step_dist']:.3f}  "
          f"sequential {res['ms_per_step_seq']:.3f} ({res['device']})")
    if not res["within_pins"]:
        raise AssertionError(f"distributed != sequential at init: {res}")
    if abs(res["acc_dist"] - res["acc_seq"]) >= ACC_PIN:
        raise AssertionError("distributed != sequential accuracy")
    print("distributed ≡ sequential ✓")
    return res


if __name__ == "__main__":
    main()

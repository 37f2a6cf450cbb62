"""Quickstart on the PyTorch port: the paper's operator algebra in a minute
(the port of ``examples/quickstart.py``).

Builds a distributed 2-layer MLP from the paper's §4 affine algorithm on a
(fo, fi) mesh, 2 x 4 by default: the WHOLE network is one ``dist_jit``
region with ``Partitioned`` logical specs.  Verifies the operators with
the paper's Eq. 13 adjoint test (``check_adjoint``) and takes a few
gradient steps: distributed and sequential losses match to float
tolerance.  One process per rank (``launch.mesh.spawn``): NCCL with one
rank per card for ``--device cuda`` (the default; too few cards raise),
gloo for ``cpu``.

Run:  python examples/quickstart_torch.py [--device cpu] [--mesh 2,4]
"""

import argparse
import functools
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core import check_adjoint, linop  # noqa: E402
from repro_torch.core import layers as L  # noqa: E402
from repro_torch.core.compile import dist_jit  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.sharding import Partitioned, Policy  # noqa: E402

LOSS_PIN = 1e-4     # examples/quickstart.py


def _rank(rank, world_mesh, *, shape, device):
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = launch_mesh.make_host_mesh(shape, ("fo", "fi"), device=device)
    log = []

    # --- 1. the operator algebra + the paper's Eq. 13 adjoint test --------
    k = shape[1]
    R = linop.SumReduce("fi")
    H = linop.HaloExchange("fi", 0, 1, 1)
    chain = H @ linop.SendRecv("fi", 1) @ linop.AllGather("fi", 0)
    reports = {"sum_reduce": check_adjoint(R, mesh, (2 * k, 3), device=dev),
               "halo_exchange": check_adjoint(H, mesh, (2 * k, 3),
                                              device=dev),
               "composite chain": check_adjoint(chain, mesh, (2 * k, 3),
                                                device=dev)}
    for name, rep in reports.items():
        log.append(f" {name:16s} : {rep}")
    reversal = chain.T == (linop.AllGather("fi", 0).T
                           @ linop.SendRecv("fi", 1).T @ H.T)
    log.append(f" reversal law     : (A@B).T == B.T @ A.T -> {reversal}")

    # --- 2. a distributed MLP: ONE dist_jit region, Partitioned specs -----
    gen = torch.Generator(device=dev).manual_seed(0)
    w1 = torch.randn((64, 32), generator=gen, device=dev) * 0.1
    b1 = torch.zeros((64,), device=dev)
    w2 = torch.randn((10, 64), generator=gen, device=dev) * 0.1
    b2 = torch.zeros((10,), device=dev)
    x = torch.randn((16, 32), generator=gen, device=dev)
    y = F.one_hot(torch.randint(0, 10, (16,), generator=gen, device=dev),
                  10).float()

    def mlp_body(params, x):
        """Local-block body: restriction glue + two §4 affine chains."""
        w1, b1, w2, b2 = params
        h = L.affine(L.shard_slice(x, "fi", -1), w1, b1,
                     fo_axis="fo", fi_axis="fi")
        h = F.relu(h)
        h = linop.AllGather("fo", 1)(h)          # fo -> fi repartition glue
        return L.affine(L.shard_slice(h, "fi", -1), w2, b2,
                        fo_axis="fo", fi_axis="fi")

    w_part, b_part = Partitioned("fo", "fi"), Partitioned("fo")
    mlp = dist_jit(mlp_body, Policy.for_mesh(mesh),
                   ((w_part, b_part, w_part, b_part), None),
                   Partitioned(None, "fo"))

    def seq(params, x):
        w1, b1, w2, b2 = params
        return F.relu(x @ w1.T + b1) @ w2.T + b2

    log.append("\n== distributed vs sequential training (paper §5 "
               "methodology) ==")
    params = (w1, b1, w2, b2)
    deltas = []
    for step in range(5):
        pd = tuple(p.clone().requires_grad_() for p in params)
        ps = tuple(p.clone().requires_grad_() for p in params)
        ld = ((mlp(pd, x) - y) ** 2).mean()
        ls = ((seq(ps, x) - y) ** 2).mean()
        gd = torch.autograd.grad(ld, pd)
        gs = torch.autograd.grad(ls, ps)
        grad_delta = max(float((a - b).abs().max()) for a, b in zip(gd, gs))
        deltas.append(abs(float(ld.detach()) - float(ls.detach())))
        params = tuple((p - 0.1 * g).detach() for p, g in zip(params, gd))
        log.append(f" step {step}: dist loss {float(ld.detach()):.6f}   "
                   f"seq loss {float(ls.detach()):.6f}   max grad delta "
                   f"{grad_delta:.2e}")
    return {"log": "\n".join(log), "eq13": {n: [r.rel_err, r.passed]
                                            for n, r in reports.items()},
            "reversal": reversal, "loss_deltas": deltas}


def main(argv=None) -> dict:
    """Run the quickstart; returns rank 0's results.  Raises when an
    Eq. 13 check fails or the losses differ."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mesh", default="2,4",
                    help="(fo, fi) mesh shape: one rank each")
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.mesh.split(","))
    print("== operator algebra (paper Eq. 13, check_adjoint) ==")
    res = launch_mesh.spawn(
        functools.partial(_rank, shape=shape, device=args.device),
        math.prod(shape), device=args.device, timeout_s=600)[0]
    print(res["log"])
    if not all(passed for _, passed in res["eq13"].values()):
        raise AssertionError(f"Eq. 13 fails: {res['eq13']}")
    if not res["reversal"] or max(res["loss_deltas"]) >= LOSS_PIN:
        raise AssertionError(f"distributed != sequential: {res}")
    print("\ndistributed == sequential ✓ (the paper's §5 result, in "
          "miniature)")
    return res


if __name__ == "__main__":
    main()

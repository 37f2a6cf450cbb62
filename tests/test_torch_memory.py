"""The port's linear memory model (``repro_torch/core/memory.py``) against
the JAX package's (``repro/core/memory.py``), case by case as
tests/test_memory_adjoints.py holds the reference.

Each operator is an autograd ``Function`` whose backward is the paper's
App. A adjoint written by hand; Eq. 13 holds at the reference's pin
(1e-5), and the forward and the vector-Jacobian product on the same numpy
draws equal the JAX ``custom_vjp`` outputs bitwise (the operators only
copy and add once).  The in-place operators act on their input's memory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, strategies as st

from repro.core import memory as jmem
from repro_torch.core import memory as mem
from repro_torch.core.adjoint import adjoint_test

EPS = 1e-5


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _parity(port_f, jax_f, n, seed=0, inplace=False, eps=EPS):
    """Eq. 13 on the port's op, then its forward and vjp against JAX's on
    the same draws; returns the port's report."""
    x = _x(n, seed)
    r = adjoint_test(port_f, torch.from_numpy(x), eps=eps)
    assert r.passed, r
    fx_j, vjp = jax.vjp(jax_f, jnp.asarray(x))
    y = _x(fx_j.shape[0], seed + 1)
    (xbar_j,) = vjp(jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    arg = xt.clone()
    fx = port_f(arg)
    if inplace:   # the operator wrote into its input's own memory
        assert fx.data_ptr() == arg.data_ptr()
    (xbar,) = torch.autograd.grad(fx, xt, torch.from_numpy(y))
    np.testing.assert_array_equal(fx.detach().numpy(), np.asarray(fx_j))
    np.testing.assert_array_equal(xbar.numpy(), np.asarray(xbar_j))
    r = adjoint_test(port_f, torch.from_numpy(x), torch.from_numpy(y),
                     eps=eps)
    assert r.passed, r
    return r


class TestMemoryOps:
    def test_allocate_adjoint_is_deallocate(self):
        _parity(lambda x: mem.allocate(x, 5), lambda x: jmem.allocate(x, 5), 7)

    def test_deallocate_adjoint_is_allocate(self):
        _parity(lambda x: mem.deallocate(x, 3),
                lambda x: jmem.deallocate(x, 3), 9)

    def test_clear_self_adjoint(self):
        _parity(lambda x: mem.clear(x, 2, 6), lambda x: jmem.clear(x, 2, 6),
                8, inplace=True)

    def test_add_adjoint_reverses_direction(self):
        _parity(lambda x: mem.add(x, (0, 3), (3, 6)),
                lambda x: jmem.add(x, (0, 3), (3, 6)), 6, inplace=True)
        # S*_{a->b} = S_{b->a} explicitly (paper Eq. 7)
        x = torch.from_numpy(_x(6, 1)).requires_grad_()
        y = torch.from_numpy(_x(6, 2))
        (xbar,) = torch.autograd.grad(mem.add(x.clone(), (0, 3), (3, 6)), x,
                                      y)
        torch.testing.assert_close(xbar, mem.add(y.clone(), (3, 6), (0, 3)))

    def test_copy_inplace(self):
        _parity(lambda x: mem.copy_inplace(x, (0, 4), (4, 8)),
                lambda x: jmem.copy_inplace(x, (0, 4), (4, 8)), 8,
                inplace=True)

    def test_copy_outofplace(self):
        _parity(lambda x: mem.copy_outofplace(x, (1, 4)),
                lambda x: jmem.copy_outofplace(x, (1, 4)), 6)

    def test_move_inplace_adjoint_is_reverse_move(self):
        f = lambda x: mem.move_inplace(x, (0, 3), (3, 6))
        _parity(f, lambda x: jmem.move_inplace(x, (0, 3), (3, 6)), 6,
                inplace=True)
        # M*_{a->b} = M_{b->a} (paper §2)
        x = torch.from_numpy(_x(6, 3)).requires_grad_()
        y = torch.from_numpy(_x(6, 4))
        (xbar,) = torch.autograd.grad(f(x.clone()), x, y)
        torch.testing.assert_close(xbar,
                                   mem.move_inplace(y.clone(), (3, 6), (0, 3)))

    def test_move_outofplace(self):
        _parity(lambda x: mem.move_outofplace(x, (0, 2)),
                lambda x: jmem.move_outofplace(x, (0, 2)), 5)

    def test_take_linear(self):
        _parity(lambda x: mem.take_linear(x, (4, 1, 1, 0)),
                lambda x: jmem.take_linear(x, (4, 1, 1, 0)), 5)


@settings(max_examples=25, deadline=None)
@given(
    n=st.integers(2, 64),
    data=st.data(),
    seed=st.integers(0, 2**16),
)
def test_memory_ops_adjoint_property(n, data, seed):
    """Property: every memory op passes Eq. 13 for arbitrary subset
    choices, and agrees with the reference on them."""
    lo = data.draw(st.integers(0, n - 1))
    hi = data.draw(st.integers(lo + 1, n))
    _parity(lambda v: mem.clear(v, lo, hi), lambda v: jmem.clear(v, lo, hi),
            n, seed)
    _parity(lambda v: mem.allocate(v, hi - lo),
            lambda v: jmem.allocate(v, hi - lo), n, seed)
    width = hi - lo
    if hi + width <= n:
        a, b = (lo, hi), (hi, hi + width)
        for op in ("add", "copy_inplace", "move_inplace"):
            _parity(lambda v: getattr(mem, op)(v, a, b),
                    lambda v: getattr(jmem, op)(v, a, b), n, seed)


def test_forward_semantics():
    """The operators do what the paper says they do; the in-place ones
    overwrite their input."""
    def x():
        return torch.arange(1.0, 7.0)
    assert torch.equal(mem.allocate(x(), 2),
                       torch.tensor([1, 2, 3, 4, 5, 6, 0, 0.]))
    assert torch.equal(mem.clear(x(), 0, 2), torch.tensor([0, 0, 3, 4, 5, 6.]))
    assert torch.equal(mem.add(x(), (0, 2), (2, 4)),
                       torch.tensor([1, 2, 4, 6, 5, 6.]))
    v = x()
    mem.copy_inplace(v, (0, 2), (2, 4))
    assert torch.equal(v, torch.tensor([1, 2, 1, 2, 5, 6.]))
    v = x()
    mem.move_inplace(v, (0, 2), (2, 4))
    assert torch.equal(v, torch.tensor([0, 0, 1, 2, 5, 6.]))
    v = x()
    assert torch.equal(mem.copy_outofplace(v, (1, 3)),
                       torch.tensor([1, 2, 3, 4, 5, 6, 2, 3.]))
    assert torch.equal(v, x())   # out of place: the input is untouched
    assert torch.equal(mem.move_outofplace(x(), (1, 3)),
                       torch.tensor([1, 4, 5, 6, 2, 3.]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_inplace_ops_refuse_a_leaf_and_run_in_fp64(dtype):
    """An in-place operator cannot take a leaf that requires grad (torch's
    own rule for in-place operations); each operator passes Eq. 13 in fp32
    and fp64 through a copy."""
    leaf = torch.zeros(8, dtype=dtype, requires_grad=True)
    with pytest.raises(RuntimeError, match="leaf Variable"):
        mem.copy_inplace(leaf, (0, 4), (4, 8))
    x = torch.from_numpy(_x(12, 5)).to(dtype)
    for f in (lambda v: mem.clear(v, 3, 9),
              lambda v: mem.add(v, (0, 4), (6, 10)),
              lambda v: mem.copy_inplace(v, (0, 4), (6, 10)),
              lambda v: mem.move_inplace(v, (0, 4), (6, 10)),
              lambda v: mem.copy_outofplace(v, (2, 7)),
              lambda v: mem.move_outofplace(v, (2, 7)),
              lambda v: mem.take_linear(v, torch.tensor([3, 3, 0, 11])),
              lambda v: mem.deallocate(mem.allocate(v, 4), 6)):
        r = adjoint_test(f, x, eps=1e-12 if dtype == torch.float64 else EPS)
        assert r.passed, r

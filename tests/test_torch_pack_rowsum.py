"""The shade pack's material gather and its fixed-order backward (K12's
plain version, ops/row_sum.py), on the CPU.

Tolerances: the row sums within float rounding of ``index_add_`` (rtol
1e-5 and 1e-6 * max|index_add_|: both sum the same rows in another
order), and to the bit against a scalar float32 model of the kernel's
order; the pack's material gradients against the reference's
``jax.grad`` within 5e-4 * max|reference| (the training step's bar in
test_torch_grad.py, where scatter-adds sum in another order).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from myraytracer_tpu.ops import shade as rshade

from myraytracer_tpu_torch.ops import graphs
from myraytracer_tpu_torch.ops import row_sum as rs
from myraytracer_tpu_torch.ops import shade

from test_torch_scene import office, to_port

# one intra-op thread per process (several pytest workers share the host)
torch.set_num_threads(1)

MAT_FIELDS = ("mat_diffuse", "mat_ambient", "mat_specular", "mat_shininess",
              "mat_mirror", "mat_shadowable")


def _rows(T, M, seed, empty=None, width=48):
    """Seeded cotangents [T, 16] (a column slice of [T, width] when width
    is over 16) and ids [T] in [0, M), none equal to ``empty``."""
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn((T, width), generator=gen)[:, width - 16:]
    ids = torch.randint(0, M, (T,), generator=gen, dtype=torch.int32)
    if empty is not None:
        ids[ids == empty] = (empty + 1) % M
    return g, ids


def _kernel_order(g, ids, M):
    """The kernel's sums, one float32 add at a time (csrc/pack_rowsum.cu's
    comment): slots in range order, lanes then warps halved, the ranges'
    partials in order."""
    g, ids = g.numpy(), ids.numpy()
    T, f = g.shape[0], np.float32
    n = -(-T // rs.CHUNK)
    out = np.zeros((M, 16), f)
    for m in range(M):
        total = np.zeros(16, f)
        for r in range(n):
            slots = np.zeros((rs.THREADS, 16), f)
            for j in range(rs.THREADS):
                for k in range(rs.PER):
                    t = r * rs.CHUNK + k * rs.THREADS + j
                    if t < T and ids[t] == m:
                        slots[j] = slots[j] + g[t]
            x = slots.reshape(rs.THREADS // 32, 32, 16)
            while x.shape[1] > 1:
                h = x.shape[1] // 2
                x = x[:, :h] + x[:, h:]
            x = x[:, 0]
            while x.shape[0] > 1:
                h = x.shape[0] // 2
                x = x[:h] + x[h:]
            total = total + x[0]
        out[m] = total
    return out


@pytest.mark.parametrize("T,M,empty,group", [
    (1, 1, None, None),            # one row
    (1023, 3, None, None),         # under one range
    (1024, 5, 2, None),            # one whole range, an empty material
    (3001, 20, 7, None),           # ragged last range
    (5000, 300, 11, None),         # many materials
    (5000, 300, 11, 3),            # the same, summed three materials at a time
])
def test_row_sum_plain_matches_index_add(monkeypatch, T, M, empty, group):
    g, ids = _rows(T, M, seed=T + M, empty=empty)
    got = rs.row_sum_plain(g, ids, M)
    if group is not None:
        monkeypatch.setattr(rs, "_PLAIN_FLOATS",
                            group * rs.THREADS * rs.COLS * -(-T // rs.CHUNK))
        assert torch.equal(rs.row_sum_plain(g, ids, M), got)
    want = torch.zeros(M, 16).index_add_(0, ids.long(), g)
    assert got.shape == (M, 16) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    if empty is not None:
        assert not bool(got[empty].any())
    # a contiguous copy of the slice gives the same bits
    assert torch.equal(rs.row_sum_plain(g.contiguous(), ids, M), got)


@pytest.mark.parametrize("T,M", [(300, 2), (2500, 3)])
def test_row_sum_plain_takes_the_kernels_order(T, M):
    """Bit for bit the kernel's order, on values whose sum depends on it
    (magnitudes 1e-3 to 1e5)."""
    g, ids = _rows(T, M, seed=3)
    scale = torch.logspace(-3, 5, T)[torch.randperm(
        T, generator=torch.Generator().manual_seed(4))]
    g = g * scale[:, None]
    got = rs.row_sum_plain(g, ids, M)
    assert np.array_equal(got.numpy(), _kernel_order(g, ids, M))
    assert not torch.equal(
        got, torch.zeros(M, 16).index_add_(0, ids.long(), g))


def test_row_sum_checks_its_inputs():
    g, ids = _rows(10, 2, seed=1)
    with pytest.raises(ValueError, match="int32"):
        rs.row_sum(g, ids.long(), 2)
    with pytest.raises(ValueError, match=r"\[T, 16\]"):
        rs.row_sum(g[:, :8], ids, 2)
    with pytest.raises(ValueError, match="rows"):
        rs.row_sum(g, ids, 0)


@pytest.fixture(scope="module")
def office_pair():
    ref = office("ref", tess=2).build()
    return ref, to_port(ref)


def _tally():
    return graphs.TALLIES["pack.rowsum"]


def test_pack_material_grads_match_reference(office_pair):
    """The gradients that the pack's material gather gives the material
    table on office at tess 2 (loss: tri_pack against seeded weights)
    match the reference's jax.grad of its pack; the gather takes the row
    sum once, with its tally."""
    ref, port = office_pair
    T = port.n_tris
    w = np.random.default_rng(6).normal(size=(T, 48)).astype(np.float32)

    def r_loss(mats):
        sc = dataclasses.replace(ref, **mats)
        return jnp.sum(rshade.pack_shade_geom(sc).tri_pack * w)

    r_grads = jax.grad(r_loss)({k: getattr(ref, k) for k in MAT_FIELDS})
    leaves = {k: getattr(port, k).detach().clone().requires_grad_(True)
              for k in MAT_FIELDS}
    before = _tally()
    tri_pack = shade.pack_shade_geom(
        dataclasses.replace(port, **leaves)).tri_pack
    assert _tally() == before + 1
    grads = torch.autograd.grad(torch.sum(tri_pack * torch.from_numpy(w)),
                                list(leaves.values()))
    for k, got in zip(leaves, grads):
        want = np.asarray(r_grads[k])
        assert float(np.abs(want).max()) > 0, k
        tol = 5e-4 * float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol,
                                   err_msg=k)


class OpNames(TorchDispatchMode):
    """The ATen ops dispatched under it, by name, in order."""

    def __enter__(self):
        self.names = []
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("grad", [False, True])
def test_pack_dispatches_the_plain_gather(office_pair, monkeypatch, grad):
    """The pack's forward dispatches the ops of plain indexing,
    ``mat16[tri_mat.long()]``, with or without a gradient; only a table
    that requires one takes the row sum (and its tally)."""
    port = office_pair[1]
    if grad:
        port = dataclasses.replace(
            port, mat_diffuse=port.mat_diffuse.clone().requires_grad_(True))
    before = _tally()
    with OpNames() as got:
        pack = shade.pack_shade_geom(port)
    assert _tally() == before + int(grad)
    assert pack.tri_pack.requires_grad == grad
    monkeypatch.setattr(rs, "gather_rows",
                        lambda table, ids, plain=False: table[ids.long()])
    with OpNames() as want:
        plain = shade.pack_shade_geom(port)
    assert got.names == want.names
    assert collections.Counter(got.names)["index.Tensor"] >= 1
    assert torch.equal(pack.tri_pack, plain.tri_pack)

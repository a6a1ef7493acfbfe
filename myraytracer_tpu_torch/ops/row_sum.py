"""The material gather of the shade pack and its fixed-order backward (K12).

``shade.pack_shade_geom`` copies each triangle's material row into
``tri_pack[:, 32:48]``: ``mat16[tri_mat]``. Its backward sums the
cotangent of the gathered rows, g [T, 16], into the material table's
cotangent [M, 16] by id. PyTorch's backward of an index gather sorts the
ids on every call and walks each run of equal ids serially; K12
(``csrc/pack_rowsum.cu``) sums them instead in a fixed order that
depends only on T, M and its launch shape, with no float atomics:

  pass 1: rows are cut into ranges of :data:`CHUNK`; for each (range,
      material) each of :data:`THREADS` slots adds, in order k = 0 ..
      :data:`PER` - 1, the row ``range * CHUNK + k * THREADS + slot``
      where its id is the material; then the slots are summed by a tree
      that halves the lanes of each warp of 32 (lane i + lane i + half)
      and then the warps (the same way) -> a partial per range and
      material;
  pass 2: each material's partials are added in range order.

:func:`row_sum_plain` takes the same sums in the same order with
elementwise PyTorch ops, so the kernel equals it to the bit, and both
stay within float rounding of ``index_add_``. :func:`gather_rows` is the
gather that ``pack_shade_geom`` calls: where the table requires a
gradient, :class:`GatherRows`, whose backward is K12 (its plain version
on CPU tensors or with ``plain``), and the tally ``"pack.rowsum"``;
otherwise plain indexing.
"""

from __future__ import annotations

import torch

from myraytracer_tpu_torch.kernels import _build
from myraytracer_tpu_torch.ops import graphs

#: slots of a range (pass 1's block), in warps of 32
THREADS = 128
#: rows a slot visits in a range
PER = 8
#: rows of a range
CHUNK = THREADS * PER
#: columns of a row
COLS = 16
#: floats of the plain version's slot sums per group of materials
_PLAIN_FLOATS = 1 << 22


def _check(g, ids, rows: int) -> None:
    if g.dim() != 2 or g.shape[1] != COLS or ids.shape != (g.shape[0],):
        raise ValueError(f"row_sum: g must be [T, {COLS}] and ids [T], got "
                         f"{tuple(g.shape)} and {tuple(ids.shape)}")
    if g.dtype != torch.float32 or ids.dtype != torch.int32:
        raise ValueError(f"row_sum: g must be float32 and ids int32, got "
                         f"{g.dtype} and {ids.dtype}")
    if not 0 < rows < 65536:
        raise ValueError(f"row_sum: {rows} table rows (1 to 65535)")


def row_sum_plain(g: torch.Tensor, ids: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """Plain version of :func:`row_sum`: the kernel's sums in its order
    (module docstring), on any device."""
    _check(g, ids, rows)
    T = g.shape[0]
    n = -(-T // CHUNK)
    pad = n * CHUNK - T
    gv = torch.nn.functional.pad(g, (0, 0, 0, pad)).view(n, PER, THREADS,
                                                         COLS)
    iv = torch.nn.functional.pad(ids, (0, pad), value=-1).view(n, PER,
                                                               THREADS)
    part = g.new_empty((n, rows, COLS))
    group = max(1, _PLAIN_FLOATS // max(1, n * THREADS * COLS))
    for m0 in range(0, rows, group):
        mats = torch.arange(m0, min(rows, m0 + group), device=g.device,
                            dtype=torch.int32)
        acc = g.new_zeros((n, mats.shape[0], THREADS, COLS))
        for k in range(PER):
            hit = (iv[:, None, k] == mats[None, :, None])[..., None]
            acc = torch.where(hit, acc + gv[:, None, k], acc)
        # the lanes of each warp, then the warps: halve, adding i + half
        x = acc.view(n, mats.shape[0], THREADS // 32, 32, COLS)
        while x.shape[3] > 1:
            h = x.shape[3] // 2
            x = x[:, :, :, :h] + x[:, :, :, h:]
        while x.shape[2] > 1:
            h = x.shape[2] // 2
            x = x[:, :, :h] + x[:, :, h:]
        part[:, m0:m0 + mats.shape[0]] = x[:, :, 0, 0]
    out = g.new_zeros((rows, COLS))
    for r in range(n):
        out = out + part[r]
    return out


def row_sum(g: torch.Tensor, ids: torch.Tensor, rows: int) -> torch.Tensor:
    """The rows of g [T, 16] f32 summed by ids [T] i32 (each in [0,
    rows)) -> [rows, 16] (K12 on CUDA tensors; the plain version on CPU
    tensors). g may be a view with a row stride, such as a column slice
    of a wider table's cotangent. Two calls on the same inputs give the
    same bits, and equal :func:`row_sum_plain`'s."""
    if g.device.type == "cpu":
        return row_sum_plain(g, ids, rows)
    _check(g, ids, rows)
    if (g.stride(1) != 1 or g.stride(0) % 4 or g.data_ptr() % 16
            or g.stride(0) < COLS):
        g = g.contiguous()
    _build.check_inputs("row_sum", g.device, ids_i=ids)
    dev, T = g.device, g.shape[0]
    words = _build.library().mrt_pack_rowsum_workspace(T, rows)
    part = torch.empty(max(words, 1), dtype=torch.float32, device=dev)
    out = torch.empty((rows, COLS), dtype=torch.float32, device=dev)
    _build.launch("mrt_pack_rowsum", "pack_rowsum", dev, g.data_ptr(),
                  g.stride(0), ids.data_ptr(), T, rows, part.data_ptr(),
                  out.data_ptr())
    return out


class GatherRows(torch.autograd.Function):
    """``table[ids]`` whose backward sums the row cotangents by id with
    :func:`row_sum` (``plain=True``: :func:`row_sum_plain` on any
    device). ``GatherRows.apply(table [M, 16] f32, ids [T] i32, plain)``
    -> [T, 16]."""

    @staticmethod
    def forward(ctx, table, ids, plain):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        ctx.plain = plain
        return table[ids.long()]

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        fn = row_sum_plain if ctx.plain else row_sum
        return fn(g, ids, ctx.rows), None, None


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                plain: bool = False) -> torch.Tensor:
    """``table[ids]``: through :class:`GatherRows` (and one tally
    ``"pack.rowsum"``) where ``table`` requires a gradient, else plain
    indexing."""
    if not table.requires_grad:
        return table[ids.long()]
    graphs.tally("pack.rowsum")
    return GatherRows.apply(table, ids, plain)

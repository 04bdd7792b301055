"""The exchange layer's copy primitive (``ops/cuda/strided_copy.py``,
``csrc/strided_copy.cu``) on the CPU: the layouts it hands the kernel (at
the full size of the sharded 2-D cell's three copies, on meta tensors),
the plain version against ``Tensor.copy_``, a numpy emulation of both
bodies' index arithmetic (the tiled body's walk of tiles, outer offsets
and masks; the straight body's 16-byte rescaling) against ``copy_``, and
the wrapper's refusals. The kernel itself runs in
``tests/test_torch_strided_copy_card.py``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fourier_tpu_torch.ops.cuda import strided_copy as sc

SOURCE = (Path(sc.__file__).resolve().parents[2] / "csrc" / "strided_copy.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


TILE, ROWS = _constant("kTile"), _constant("kRows")


def _cell_copies(images=128, rows=1024, n=4096, ranks=4, chunks=4, device="meta"):
    """(dst, src) of one plane of each copy an Fft2dPlan call makes on a
    rank of the sharded 2-D cell: leg 1's gather of a row chunk (n2 to the
    front), leg 2's gather of one piece (its n1 chunk along n1, b last),
    ``assemble``'s copy of the last exchange's blocks to (b, n1, n2)."""
    c = rows // chunks
    x = torch.empty(images, rows, n, device=device)
    leg1_src = x.narrow(1, 0, c).permute(2, 0, 1)
    leg1_dst = torch.empty(n, images, c, device=device)
    piece = torch.empty(ranks, rows, images, c, device=device)  # (^n1, n2, b, n1 chunk)
    leg2_dst = torch.empty(ranks, rows, rows, images, device=device).narrow(1, c, c)
    leg2_src = piece.permute(0, 3, 1, 2)
    blocks = torch.empty(ranks, rows, rows, images, device=device)  # (^n2, n1, n2, b)
    asm_src = blocks.permute(3, 1, 0, 2)
    asm_dst = torch.empty(images, rows, ranks, rows, device=device)
    return {"leg1_gather": (leg1_dst, leg1_src), "leg2_gather": (leg2_dst, leg2_src),
            "assemble": (asm_dst, asm_src)}


def test_cell_copies_are_tiled_with_their_strides():
    """The three copies of a call of the sharded 2-D cell, at its full size:
    each transposes the source's innermost dim (stride 1) against the
    destination's; the outer dims stay apart but where both sides lay two
    of them as one."""
    got = {k: sc.copy_layout(d, s) for k, (d, s) in _cell_copies().items()}
    n, r, b, c = 4096, 1024, 128, 256
    assert got["leg1_gather"] == sc.CopyLayout(
        (n, b, c), (1, r * n, n), (b * c, c, 1), 0)
    assert got["leg2_gather"] == sc.CopyLayout(  # (n2, b) merge on both sides
        (4, c, r * b), (r * b * c, 1, c), (r * r * b, r * b, 1), 1)
    assert got["assemble"] == sc.CopyLayout(
        (b, r, 4, r), (1, r * b, r * r * b, b), (r * 4 * r, 4 * r, r, 1), 0)
    assert all(layout.tiled for layout in got.values())


@pytest.mark.parametrize("shape,perm,merged", [
    ((6, 10), (0, 1), (60,)),  # contiguous: one dim
    ((4, 1, 5, 3), (0, 1, 2, 3), (60,)),  # a unit dim dropped
    ((4, 5, 3), (2, 0, 1), None),
    ((2, 3, 4, 5), (0, 1, 3, 2), (6, 5, 4)),  # the two outer dims merge on both sides
])
def test_layout_drops_and_merges(shape, perm, merged):
    src = torch.empty(shape).permute(perm)
    dst = torch.empty(src.shape)
    layout = sc.copy_layout(dst, src)
    if merged is not None:
        assert layout.size == merged
    assert np.prod(layout.size) == src.numel()
    assert layout.dst_stride[-1] == 1 and layout.src_stride[layout.sdim] == 1


def test_empty_copy_has_no_layout():
    assert sc.copy_layout(torch.empty(0, 3), torch.empty(3, 0).T) is None
    assert sc.strided_copy([torch.empty(0, 3)], [torch.empty(3, 0).T]) == []


# -- a numpy emulation of the kernel's walk --------------------------------------------


def _outer(layout, skip, rest):
    """outer_offsets: the outer dims (all but the last and `skip`),
    innermost first."""
    so = do = 0
    for k in range(len(layout.size) - 2, -1, -1):
        if k == skip:
            continue
        i, rest = rest % layout.size[k], rest // layout.size[k]
        so += i * layout.src_stride[k]
        do += i * layout.dst_stride[k]
    return so, do


def emulate(layout, src: np.ndarray, dst: np.ndarray, grid: int = 7) -> int:
    """The body of ``csrc/strided_copy.cu`` that `layout` picks, over flat
    element arrays `src` and `dst` (the planes' storages from their first
    element), blocks walked in grid-stride order over `grid` blocks; the
    number of element writes."""
    writes = 0
    nd_ = len(layout.size)
    if layout.tiled:
        sd, dd = layout.sdim, nd_ - 1
        ns, nd = layout.size[sd], layout.size[dd]
        tiles_s, tiles_d = -(-ns // TILE), -(-nd // TILE)
        ntiles = tiles_s * tiles_d * int(np.prod([layout.size[k] for k in range(nd_ - 1)
                                                  if k != sd]))
        lane = np.arange(32)
        for block in range(grid):
            for t in range(block, ntiles, grid):
                td, ts = t % tiles_d, (t // tiles_d) % tiles_s
                so, do = _outer(layout, sd, t // tiles_d // tiles_s)
                s0, d0 = ts * TILE, td * TILE
                tile = np.zeros((TILE, TILE + 1), src.dtype)
                for row in range(ROWS):  # read: lanes along s, rows along d
                    for j in range(TILE // ROWS):
                        d = d0 + row + j * ROWS
                        for i in range(TILE // 32):
                            s = s0 + lane + i * 32
                            ok = (d < nd) & (s < ns)
                            tile[row + j * ROWS, (lane + i * 32)[ok]] = src[
                                so + s[ok] * layout.src_stride[sd] + d * layout.src_stride[dd]]
                for row in range(ROWS):  # write: lanes along d, rows along s
                    for j in range(TILE // ROWS):
                        s = s0 + row + j * ROWS
                        for i in range(TILE // 32):
                            d = d0 + lane + i * 32
                            ok = (d < nd) & (s < ns)
                            dst[do + s * layout.dst_stride[sd] + d[ok] * layout.dst_stride[dd]] = \
                                tile[(lane + i * 32)[ok], row + j * ROWS]
                            writes += int(ok.sum())
        return writes
    n = layout.size[-1]
    total = int(np.prod(layout.size))
    for e in range(total):
        so, do = _outer(layout, -1, e // n)
        i = e % n
        dst[do + i * layout.dst_stride[-1]] = src[so + i * layout.src_stride[-1]]
        writes += 1
    return writes


def _vectorized(layout, per: int):
    """vectorize(): the straight body's layout in 16-byte vectors of `per`
    elements, or None where a side is not unit-stride along the innermost
    dim or an extent or outer stride does not divide."""
    last = len(layout.size) - 1
    if (layout.tiled or layout.src_stride[last] != 1 or layout.dst_stride[last] != 1
            or layout.size[last] % per
            or any(s % per for s in layout.src_stride[:last] + layout.dst_stride[:last])):
        return None
    div = lambda v: tuple(x // per for x in v[:last]) + (1,)
    return sc.CopyLayout(layout.size[:last] + (layout.size[last] // per,),
                         div(layout.src_stride), div(layout.dst_stride), layout.sdim)


def _case(shape, perm, narrow=None, dtype=torch.float32):
    """A source view (a permutation of a contiguous tensor) and a
    destination of its shape (a contiguous tensor, or a narrowed slice of a
    larger one: (dim, start, grown by))."""
    g = torch.Generator().manual_seed(len(shape) * 31 + sum(shape))
    base = torch.randn(shape, generator=g, dtype=dtype)
    src = base.permute(perm)
    if narrow is None:
        return torch.full(src.shape, float("nan"), dtype=dtype), src
    dim, start, grow = narrow
    big = list(src.shape)
    big[dim] += grow
    return torch.full(big, float("nan"), dtype=dtype).narrow(dim, start, src.shape[dim]), src


EMULATED = {
    # the three copies of the sharded 2-D cell, cut to a few tiles
    "leg1_gather": ((2, 40, 96), (2, 0, 1), None),
    "leg2_gather": ((3, 20, 4, 40), (0, 3, 1, 2), (1, 10, 50)),
    "assemble": ((3, 6, 8, 5), (3, 1, 0, 2), None),
    # ragged both ways, both a tile and less
    "ragged": ((33, 70), (1, 0), None),
    "thin_dst": ((65, 3), (1, 0), None),
    "pencil": ((4, 6, 40), (1, 2, 0), None),
    # the straight body: vectorizable, and an odd extent that is not
    "straight_vec": ((3, 8, 16), (1, 0, 2), (0, 0, 3)),
    "straight_odd": ((3, 5, 7), (1, 0, 2), None),
}


@pytest.mark.parametrize("name", sorted(EMULATED))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_emulated_kernel_equals_copy(name, dtype):
    """Each body's walk, emulated on the planes' storages, writes every
    element of the destination once and leaves its neighbours (NaN) alone,
    equal to ``copy_``; the 16-byte straight layout copies the same."""
    dst, src = _case(*EMULATED[name], dtype=dtype)
    layout = sc.copy_layout(dst, src)
    whole = dst if dst._base is None else dst._base
    want = whole.clone()
    want.as_strided(dst.shape, dst.stride(), dst.storage_offset()).copy_(src)
    s_flat = src._base.numpy().reshape(-1)[src.storage_offset():]
    got = whole.clone().numpy().reshape(-1)
    assert emulate(layout, s_flat, got[dst.storage_offset():]) == src.numel()
    np.testing.assert_array_equal(got, want.numpy().reshape(-1))
    per = 16 // src.element_size()
    vec = _vectorized(layout, per)
    assert (vec is not None) == (name == "straight_vec")
    if vec is not None:
        rows = lambda a: a[: a.size // per * per].reshape(-1, per)
        got = whole.clone().numpy().reshape(-1)
        emulate(vec, rows(s_flat), rows(got[dst.storage_offset():]))
        np.testing.assert_array_equal(got, want.numpy().reshape(-1))
    assert layout.tiled == (name not in ("straight_vec", "straight_odd"))


# -- the plain version and the wrapper -----------------------------------------------


PLAIN = [((8, 16), (1, 0), None, 2), ((4, 6, 40), (1, 2, 0), (2, 3, 5), 2),
         ((3, 5, 7), (1, 0, 2), None, 4), ((2, 3, 4, 5, 6), (4, 2, 0, 3, 1), None, 1),
         ((1, 9, 1, 4), (3, 1, 2, 0), None, 3)]


@pytest.mark.parametrize("shape,perm,narrow,planes", PLAIN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_path_equals_copy(shape, perm, narrow, planes, dtype):
    """On the CPU the wrapper is ``copy_`` a plane, bitwise, into
    contiguous and narrowed destinations, 1 to 4 planes, and returns the
    one layout the planes share."""
    pairs = [_case(shape, perm, narrow, dtype) for _ in range(planes)]
    for p, (d, s) in enumerate(pairs):
        s.mul_(p + 1)
    want = [d.clone().copy_(s) for d, s in pairs]
    layouts = sc.strided_copy([d for d, _ in pairs], [s for _, s in pairs])
    assert layouts == [sc.copy_layout(*pairs[0])]
    for (d, _), w in zip(pairs, want):
        assert torch.equal(d.nan_to_num(7.0), w.nan_to_num(7.0))


def test_planes_with_other_strides_are_laid_out_apart():
    """Planes whose strides differ (a caller's transposed imaginary plane)
    give one layout each."""
    re, im = torch.randn(4, 6), torch.randn(6, 4).T
    dst = [torch.empty(6, 4), torch.empty(6, 4)]
    layouts = sc.strided_copy(dst, [re.T, im.T])
    assert len(layouts) == 2 and layouts[0].tiled and not layouts[1].tiled
    assert torch.equal(dst[0], re.T) and torch.equal(dst[1], im.T)


@pytest.mark.parametrize("what", ["dtype", "int", "mixed", "shape", "planes", "none",
                                  "overlap", "dims"])
def test_refusals(what):
    a, b = torch.empty(4, 6), torch.empty(6, 4).T
    cases = {
        "dtype": (TypeError, [a.to(torch.complex64)], [b.to(torch.complex64)]),
        "int": (TypeError, [a.to(torch.int32)], [b.to(torch.int32)]),
        "mixed": (TypeError, [a], [b.double()]),
        "shape": (ValueError, [a], [b[:3]]),
        "planes": (ValueError, [a] * 5, [b] * 5),
        "none": (ValueError, [], []),
        "overlap": (ValueError, [torch.empty(4, 1).expand(4, 6)], [b]),
        "dims": (ValueError, [torch.empty((2,) * 7)], [torch.empty((2,) * 7).permute(
            0, 2, 4, 6, 1, 3, 5)]),
    }
    err, dst, src = cases[what]
    with pytest.raises(err):
        sc.strided_copy(dst, src)


def test_operator_schema_and_fake():
    """The registered operator mutates its destinations and returns
    nothing; its fake runs on meta tensors."""
    op = torch.ops.fourier_tpu_torch.strided_copy.default
    schema = str(op._schema)
    assert "Tensor(a0!)[] dst" in schema and schema.endswith("-> ()")
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        d, s = torch.empty(6, 4), torch.empty(4, 6).T
        assert op([d], [s], [6, 4], [1, 6], [4, 1], 0) is None


def test_entry_point_matches_its_binding():
    """The library defines its C entry point with as many parameters as the
    wrapper binds, and the error-string function ``build.bind`` sets up."""
    for fn_name, argtypes in [*sc.ENTRY_POINTS.items(), ("fourier_cuda_error_string", [int])]:
        m = re.search(rf"\b{fn_name}\(([^)]*)\)\s*{{", SOURCE)
        assert m is not None, fn_name
        assert len([p for p in m.group(1).split(",") if p.strip()]) == len(argtypes), fn_name

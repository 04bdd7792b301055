"""The per-rank steps of the sharded plans: one copy into the batch-minor
layout, the 1-D plan's batch-minor call, the exchange over a mesh dim.

Port of the plane plumbing of ``fourier_tpu/parallel/sharded.py`` (``_a2a``,
``_chunked_leg`` and the chunked legs' interleaved reassembly,
``:148-187``, ``:474-507``, ``:653-688``), laid out for the card's kernels:

* Local planes travel as :class:`Blocks`: the tensors and a name for each of
  their dims. ``"^x"`` names the rank blocks of dim ``x`` that an exchange
  delivered: the full dim is ``("^x", "x")``, blocks outermost.
* :func:`gather` is the one copy of a leg: it lays dim ``x`` (its rank
  blocks merged in, outermost) in front of a contiguous buffer, the other
  dims after it in memory order, which is the (n, B) plane that the 1-D
  plans' batch-minor calls and kernels B1-B8 take. It copies from several
  pieces at once (the chunks of a pipelined leg, each where it belongs) and
  zeroes the padded tail of a dim, so no leg needs a second copy. A single
  piece that already lies so is not copied.
* Every copy of :func:`gather` and :func:`assemble` is one
  :func:`~fourier_tpu_torch.ops.cuda.strided_copy.strided_copy` a piece,
  its planes together (on a card one launch of the tiled strided copy,
  ``csrc/strided_copy.cu``), under the span ``exchange.copy[what=...]``,
  counted in ``exchange.copies``, ``exchange.copies.tiled`` (the pieces
  whose two sides' innermost dims differ) and ``exchange.copy_bytes``
  (bytes read).
* :func:`exchange` is ``jax.lax.all_to_all(..., tiled=True)`` with the split
  axis in front: ``torch.distributed.all_to_all_single`` over the mesh dim's
  process group sends contiguous block j of the leading dim to rank j of
  the group, and the S received blocks stay apart as the leading ``"^x"``
  dim, in the group's rank order, for the next :func:`gather` to lay along
  ``x``. It is issued asynchronously: the transport moves a chunk while the
  next chunk's copy and kernel run, and a piece is waited for only where
  :func:`gather` or :func:`assemble` reads it.
* :func:`leg` chains them, in ``chunks`` slices of one dim
  (``pipeline_chunks``): slicing a dim that the leg neither transforms nor
  splits, or the one it gathers, leaves every value as in the unchunked leg,
  so the two agree bitwise.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from fourier_tpu_torch import trace
from fourier_tpu_torch.ops.cuda.strided_copy import strided_copy


def outer(name: str) -> str:
    """The name of the rank blocks of dim `name`."""
    return "^" + name


class Blocks(NamedTuple):
    """Local planes (one tensor each, equal shapes), the name of each dim,
    the offset of these planes along the dims they are a slice of
    (``start``: a pipelined leg's chunk), and the exchanges (work handle,
    sent tensor) to wait for before the planes are read."""

    planes: Tuple[torch.Tensor, ...]
    names: Tuple[str, ...]
    start: Dict[str, int]
    pending: tuple = ()

    def extent(self, name: str) -> int:
        return self.planes[0].shape[self.names.index(name)]

    def end(self, name: str) -> int:
        return self.start.get(name, 0) + self.extent(name)


def local_blocks(planes: Sequence[torch.Tensor], names: Sequence[str]) -> Blocks:
    """Blocks of a rank's input planes, their dims viewed in memory order
    (no copy), so that a layout an earlier call handed back is read as it
    lies."""
    t = planes[0]
    order = sorted(range(t.ndim), key=lambda d: -t.stride(d))
    return Blocks(tuple(p.permute(order) for p in planes),
                  tuple(names[d] for d in order), {})


def _wait(piece: Blocks) -> None:
    if not piece.pending:
        return
    with trace.span("exchange.wait"):
        for work, _sent in piece.pending:
            work.wait()


def _copy(src: Sequence[torch.Tensor], dst: Sequence[torch.Tensor], what: str) -> None:
    """One piece's planes `src` into `dst` (views of one shape), counted."""
    with trace.span("exchange.copy", what=what):
        layouts = strided_copy(dst, src)
    if layouts:
        trace.count("exchange.copies")
        if any(layout.tiled for layout in layouts):
            trace.count("exchange.copies.tiled")
        trace.count("exchange.copy_bytes", sum(s.numel() * s.element_size() for s in src))


def _lead(names, name: str) -> tuple:
    return tuple(n for n in (outer(name), name) if n in names)


def gather(pieces: Sequence[Blocks], name: str, sizes: Optional[Dict[str, int]] = None,
           span: Optional[Tuple[str, int, int]] = None) -> Blocks:
    """Dim `name` (its rank blocks merged in, outermost) in front of one
    contiguous buffer a plane, the other dims after it in the first piece's
    order: each element of `pieces` copied once, to its offset. `sizes`
    gives a dim's full extent where the pieces stop short of it (a padded
    tail, zeroed); `span` = (dim, start, length) keeps that slice of a dim
    (a chunk). No copy when a single whole piece lies so already."""
    sizes = sizes or {}
    first = pieces[0]
    lead = _lead(first.names, name)
    order = lead + tuple(n for n in first.names if n not in lead)
    full = {n: sizes.get(n) or max(p.end(n) for p in pieces) for n in order}
    lo = dict.fromkeys(order, 0)
    ext = dict(full)
    if span is not None:
        lo[span[0]], ext[span[0]] = span[1], span[2]
    merged = (math.prod(ext[n] for n in lead), *(ext[n] for n in order[len(lead):]))
    names = (name, *order[len(lead):])
    start = {} if span is None else {span[0]: span[1]}
    if (len(pieces) == 1 and span is None and not first.start
            and all(full[n] == first.extent(n) for n in order)):
        perm = [first.names.index(n) for n in order]
        laid = tuple(p.permute(perm) for p in first.planes)
        if all(t.is_contiguous() for t in laid):
            _wait(first)
            return Blocks(tuple(t.view(merged) for t in laid), names, start)
    dest = tuple(torch.empty([ext[n] for n in order], dtype=p.dtype, device=p.device)
                 for p in first.planes)
    for piece in pieces:
        src, dst = list(piece.planes), list(dest)
        for n in order:
            a = max(piece.start.get(n, 0), lo[n])
            b = min(piece.end(n), lo[n] + ext[n])
            if b <= a:
                break
            src = [s.narrow(piece.names.index(n), a - piece.start.get(n, 0), b - a)
                   for s in src]
            dst = [d.narrow(order.index(n), a - lo[n], b - a) for d in dst]
        else:
            _wait(piece)
            perm = [piece.names.index(n) for n in order]
            _copy([s.permute(perm) for s in src], dst, "gather")
            continue
        if piece.planes[0].numel() == 0:
            _wait(piece)  # nothing to copy, but the exchange must finish
    for n, size in sizes.items():
        if n in order:
            a, b = max(max(p.end(n) for p in pieces), lo[n]), lo[n] + ext[n]
            if b > a:
                for d in dest:
                    d.narrow(order.index(n), a - lo[n], b - a).zero_()
    return Blocks(tuple(d.view(merged) for d in dest), names, start)


def exchange(blocks: Blocks, group, gathered: str, padded: Optional[int] = None) -> Blocks:
    """``jax.lax.all_to_all(tiled=True)`` of every plane over `group`, the
    split axis the leading dim: its block j goes to rank j of the group,
    and the S blocks received (rank order) are the new leading dim, the
    rank blocks of dim `gathered`. Asynchronous: the result's planes are
    valid once its ``pending`` work is waited for.

    `padded` is the leading dim's extent once padded to a multiple of S
    (the one-sided spectrum's ``n2p``): its rows are sent as they are, the
    pad rows not at all, and each rank receives its share of the real rows
    (a :func:`gather` with ``sizes`` zeroes the rest).

    Issued under the span ``exchange.issue``; counts one ``exchange.legs``
    and the planes' bytes (this rank's own block included) in
    ``exchange.bytes`` (``fourier_tpu_torch.trace``)."""
    s = dist.get_world_size(group)
    rows = blocks.planes[0].shape[0]
    total = rows if padded is None else padded
    if total % s:
        raise ValueError(f"leading extent {total} does not split over {s} ranks")
    block = total // s
    rest = tuple(blocks.planes[0].shape[1:])
    sizes = None
    mine = block
    if total != rows:
        sizes = [min(max(rows - j * block, 0), block) for j in range(s)]
        mine = sizes[dist.get_rank(group)]
    sent = sum(p.numel() * p.element_size() for p in blocks.planes)
    out, pending = [], []
    with trace.span("exchange.issue", bytes=sent, ranks=s):
        for p in blocks.planes:
            p = p.contiguous()
            recv = torch.empty((s * mine, *rest), dtype=p.dtype, device=p.device)
            work = dist.all_to_all_single(
                recv, p, output_split_sizes=None if sizes is None else [mine] * s,
                input_split_sizes=sizes, group=group, async_op=True)
            out.append(recv.view(s, mine, *rest))
            pending.append((work, p))
    trace.count("exchange.legs")
    trace.count("exchange.bytes", sent)
    return Blocks(tuple(out), (outer(gathered), *blocks.names), dict(blocks.start),
                  tuple(pending))


def batch_minor(fn: Callable) -> Callable[[Blocks], Blocks]:
    """The kernel step of a leg: `fn` on the (n, B) views of a gathered
    buffer's planes, its (n', B) results laid back as (n', rest...)."""

    def step(b: Blocks) -> Blocks:
        rest = b.planes[0].shape[1:]
        outs = fn(*(p.reshape(p.shape[0], -1) for p in b.planes))
        outs = outs if isinstance(outs, tuple) else (outs,)
        return b._replace(planes=tuple(o.reshape(o.shape[0], *rest) for o in outs))

    return step


def leg(pieces: Sequence[Blocks], name: str, kernel: Optional[Callable] = None,
        group=None, gathered: Optional[str] = None, chunk: Optional[str] = None,
        chunks: int = 1, sizes: Optional[Dict[str, int]] = None,
        padded: Optional[int] = None) -> list:
    """One leg: :func:`gather` dim `name` in front (the one copy), `kernel`
    (a :func:`batch_minor` step, or none), then :func:`exchange` over
    `group` gathering `gathered` (none without a group). With ``chunks`` > 1
    and dim `chunk` divisible by it, each slice of `chunk` runs the leg in
    turn and its exchange is in flight while the next slice computes.
    Returns the pieces for the next leg."""
    spans = [None]
    if chunk is not None and chunks > 1:
        extent = (sizes or {}).get(chunk) or max(p.end(chunk) for p in pieces)
        if extent % chunks == 0:
            h = extent // chunks
            spans = [(chunk, c * h, h) for c in range(chunks)]
    out = []
    for span in spans:
        b = gather(pieces, name, sizes, span)
        if kernel is not None:
            b = kernel(b)
        out.append(b if group is None else exchange(b, group, gathered, padded))
    return out


def _merges(t: torch.Tensor, counts: Sequence[int]) -> bool:
    """Whether each run of `counts` consecutive dims of `t` merges into one
    dim by a view (no copy)."""
    k = 0
    for c in counts:
        dims = [d for d in range(k, k + c) if t.shape[d] != 1]
        if any(t.stride(a) != t.stride(b) * t.shape[b] for a, b in zip(dims, dims[1:])):
            return False
        k += c
    return True


def assemble(pieces: Sequence[Blocks], want) -> Tuple[torch.Tensor, ...]:
    """Each plane of the one piece with the dims `want` (a name, or a tuple
    of names merged into one dim, outermost first; every name with its rank
    blocks outside it): a view where the layout allows it, else one copy
    into new contiguous planes."""
    (b,) = pieces
    _wait(b)
    order, shape, counts = [], [], []
    for group in want:
        size, first = 1, len(order)
        for n in ((group,) if isinstance(group, str) else group):
            for m in _lead(b.names, n):
                order.append(b.names.index(m))
                size *= b.extent(m)
        shape.append(size)
        counts.append(len(order) - first)
    laid = [p.permute(order) for p in b.planes]
    if all(_merges(t, counts) for t in laid):
        return tuple(t.reshape(shape) for t in laid)
    dest = tuple(torch.empty(shape, dtype=t.dtype, device=t.device) for t in laid)
    _copy(laid, [d.view(t.shape) for d, t in zip(dest, laid)], "assemble")
    return dest

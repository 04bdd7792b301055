"""The exchange layer's tiled strided copy (``csrc/strided_copy.cu``, the
operator ``fourier_tpu_torch::strided_copy``) on a CUDA card, bitwise
against ``Tensor.copy_``.

This module imports neither JAX nor the JAX package, so it also runs where
JAX is not installed. There, skip the tests directory's ``conftest.py``
(it sets JAX up for the CPU run):

    python -m pytest --noconftest -m cuda tests/test_torch_strided_copy_card.py

Without a card every test here skips.
"""

import pytest
import torch

from fourier_tpu_torch import trace
from fourier_tpu_torch.ops.cuda import strided_copy as sc

OP = "launches.fourier_tpu_torch::strided_copy"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m cuda` where a card is")
    return torch.device("cuda", 0)


def _cell_pieces(images, rows, n, ranks, chunk):
    """(source, destination) of each copy of an Fft2dPlan call on a rank of
    the sharded 2-D cell, at `images` images of `rows` of `n`: leg 1's
    gather of the chunk rows [chunk*c, (chunk+1)*c) with n2 to the front,
    leg 2's gather of that chunk's piece along n1 (b last), ``assemble``'s
    copy of the last exchange's (^n2, n1, n2, b) blocks to (b, n1, n2)."""
    c = rows // 4
    yield "leg1_gather", (lambda x: x.narrow(1, chunk * c, c).permute(2, 0, 1),
                          (images, rows, n), lambda: (n, images, c), None)
    yield "leg2_gather", (lambda x: x.permute(0, 3, 1, 2), (ranks, rows, images, c),
                          lambda: (ranks, rows, rows, images), (1, chunk * c, c))
    yield "assemble", (lambda x: x.permute(3, 1, 0, 2), (ranks, rows, rows, images),
                       lambda: (images, rows, ranks, rows), None)


# (name, source shape, source view, destination shape, narrowed (dim, start,
# length) of the destination or None)
CASES = [
    *[(f"{name}[{chunk}]", shape, view, dst(), narrow)
      for chunk in (0, 3)
      for name, (view, shape, dst, narrow) in _cell_pieces(8, 1024, 4096, 4, chunk)],
    # an Fft3dPlan pencil leg: (^n1, n0, n2 chunk, n1) gathered along n1
    ("pencil", (2, 64, 32, 64), lambda x: x.permute(0, 3, 1, 2), (2, 64, 64, 32), None),
    # transposed_output's result: the (b, n2, n1) view of (n1, n2, b)
    ("transposed_view", (256, 512, 3), lambda x: x.permute(2, 1, 0), (3, 512, 256), None),
    # a padded rfft tail: 11 of n2p = 12 rows gathered, the pad left alone
    ("rfft_tail", (4, 11, 96), lambda x: x.permute(1, 0, 2), (12, 4, 96), (0, 0, 11)),
    # extents off the tile, both sides and each alone
    ("ragged", (33, 70), lambda x: x.T, (70, 33), None),
    ("thin", (65, 3), lambda x: x.T, (3, 65), None),
    ("ragged_outer", (5, 1000, 37), lambda x: x.permute(0, 2, 1), (5, 37, 1000), None),
    # the straight body: 16-byte vectors, an odd extent, a strided source
    ("straight_vec", (6, 8, 256), lambda x: x.permute(1, 0, 2), (8, 6, 256), None),
    ("straight_odd", (6, 5, 7), lambda x: x.permute(1, 0, 2), (5, 6, 7), None),
    ("straight_strided", (6, 40), lambda x: x[:, ::2], (6, 20), None),
    # a narrowed chunk of a destination: the non-contiguous side written
    ("narrowed_dst", (64, 96), lambda x: x.T, (200, 64), (0, 50, 96)),
]


def _planes(case, count, dtype, device):
    name, shape, view, dshape, narrow = case
    g = torch.Generator(device=device).manual_seed(len(name) * 7 + count)
    srcs = [view(torch.randn(shape, generator=g, device=device, dtype=dtype))
            for _ in range(count)]
    whole = [torch.full(dshape, float("nan"), device=device, dtype=dtype)
             for _ in range(count)]
    dsts = [w if narrow is None else w.narrow(*narrow) for w in whole]
    return srcs, dsts, whole


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("dtype,count", [(torch.float32, 2), (torch.float64, 2),
                                         (torch.float32, 4), (torch.float64, 1)])
def test_kernel_equals_copy(cuda_device, case, dtype, count):
    """The kernel writes every element of the destination view bitwise as
    ``copy_`` does and nothing beside it, all planes in one launch."""
    srcs, dsts, whole = _planes(case, count, dtype, cuda_device)
    want = [w.clone() for w in whole]
    for w, s in zip(want, srcs):
        (w if case[4] is None else w.narrow(*case[4])).copy_(s)
    before = trace.counters()[OP]
    layouts = sc.strided_copy(dsts, srcs)
    torch.cuda.synchronize()
    assert len(layouts) == 1 and trace.counters()[OP] - before == 1
    for w, got in zip(want, whole):
        assert torch.equal(got.view(torch.int32 if dtype == torch.float32 else torch.int64),
                           w.view(torch.int32 if dtype == torch.float32 else torch.int64))


@pytest.mark.cuda
def test_cell_copies_take_the_tiled_body(cuda_device):
    """The sharded 2-D cell's three copies transpose two innermost dims."""
    for case in CASES[:6]:
        srcs, dsts, _ = _planes(case, 1, torch.float32, cuda_device)
        assert sc.copy_layout(dsts[0], srcs[0]).tiled, case[0]


@pytest.mark.cuda
def test_empty_piece_launches_nothing(cuda_device):
    src = torch.empty(0, 16, device=cuda_device).T
    dst = torch.empty(16, 0, device=cuda_device)
    before = trace.counters()[OP]
    assert sc.strided_copy([dst, dst.clone()], [src, src.clone()]) == []
    assert trace.counters()[OP] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.int32, torch.float16])
def test_unsupported_dtype_raises_on_card(cuda_device, dtype):
    """A CUDA tensor of another dtype raises; nothing falls back to
    ``copy_``."""
    src = torch.zeros(8, 16, device=cuda_device, dtype=dtype).T
    dst = torch.zeros(16, 8, device=cuda_device, dtype=dtype)
    before = trace.counters()[OP]
    with pytest.raises(TypeError):
        sc.strided_copy([dst], [src])
    assert trace.counters()[OP] == before

"""The flash kernels' launch grids take any batch x heads and any tile count.

CUDA caps grid y and z at 65,535 blocks and grid x at 2^31 - 1. The
reference runs its kernels on the grid ``(b * h, sq // bq, sk // bk)``
(``ddstore_tpu/ops/attention.py:177``, ``:366``, ``:384``), which has no
such cap, so every launch in ``ddstore_tpu_torch/ops/csrc/*.cu`` puts the
batch, the heads and the tile blocks on grid x (``sm90::GridPos``). This
file reads the sources and holds every launch to that: grid y and z are
literal constants, or clamped to 65,535 with the kernel walking the rest
in a loop (the f32 split pass's y), and a kernel reads ``blockIdx.y`` or
``.z`` only on such an axis. Each block decodes its place on x by
``sm90::FastDiv`` (a multiply-high and a shift); the last cases hold that
arithmetic, emulated in numpy as ``fast_div``/``div_by`` write it, to
integer division. The card alone builds and runs the kernels; this guard
sees every launch on the CPU.
"""

import pathlib
import re

import numpy as np
import pytest

from ddstore_tpu_torch.ops import attention

pytestmark = pytest.mark.tier1_required

CSRC = pathlib.Path(attention.__file__).parent / "csrc"
SOURCES = {p.name: p.read_text() for p in sorted(CSRC.glob("*.cu"))}
CLAMP = re.compile(r"(\w+)\s*<\s*65535\s*\?\s*\1\s*:\s*65535")
KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\(")
LAUNCH = re.compile(r"(\w+)\s*(?:<[\w\s,:]*>)?\s*<<<\s*(\w+)\s*,")


def _split_args(text):
    """The top-level comma-separated arguments of ``text``."""
    args, depth, cur = [], 0, ""
    for ch in text:
        depth += {"(": 1, "[": 1, ")": -1, "]": -1}.get(ch, 0)
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
        else:
            cur += ch
    args.append(cur.strip())
    return args


def _body(src, start):
    """The text of the brace-delimited body that opens after ``start``."""
    i = src.index("{", start)
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i:j + 1]
    raise AssertionError("unbalanced braces")


def _kernels():
    """{kernel name: (source file, body)} of every ``__global__``."""
    out = {}
    for name, src in SOURCES.items():
        for m in KERNEL.finditer(src):
            out[m.group(1)] = (name, _body(src, m.end()))
    return out


def _launches():
    """[(source file, kernel, grid arguments)] of every ``<<<...>>>``; the
    grid is the nearest ``dim3 NAME(...)`` before the launch."""
    out = []
    for name, src in SOURCES.items():
        for m in LAUNCH.finditer(src):
            kernel, grid = m.groups()
            decls = list(re.finditer(r"dim3\s+%s\s*\(([^;]*)\)\s*;"
                                     % re.escape(grid), src[:m.start()]))
            assert decls, f"{name}: {kernel}'s grid {grid} is not a dim3"
            out.append((name, kernel, _split_args(decls[-1].group(1))))
    return out


KERNELS = _kernels()
LAUNCHES = _launches()


def test_every_kernel_is_launched_and_read():
    # the parser sees every kernel of the sources and a launch of each, so
    # a later kernel cannot slip past the cases below
    assert set(SOURCES) == {"flash_fwd.cu", "flash_bwd.cu", "held_rows.cu"}
    assert len(KERNELS) >= 12
    assert {k for _, k, _ in LAUNCHES} == set(KERNELS)


@pytest.mark.parametrize("src,kernel,args", LAUNCHES,
                         ids=[f"{s}:{k}" for s, k, _ in LAUNCHES])
def test_grid_y_and_z_hold_no_size(src, kernel, args):
    assert 1 <= len(args) <= 3, args
    body = KERNELS[kernel][1]
    for axis, arg in zip("yz", args[1:]):
        if re.fullmatch(r"\d+", arg):
            continue
        assert CLAMP.fullmatch(arg), (
            f"{src}: {kernel} puts {arg!r} on grid {axis}, which CUDA caps "
            f"at 65,535; fold it onto x (sm90::GridPos)")
        assert f"+= gridDim.{axis}" in body, (
            f"{src}: {kernel} clamps grid {axis} but walks no loop over it")


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernel_reads_y_and_z_only_where_launched_so(kernel):
    src, body = KERNELS[kernel]
    grids = [args for _, k, args in LAUNCHES if k == kernel]
    for i, axis in ((1, "y"), (2, "z")):
        if not re.search(rf"(blockIdx|gridDim)\.{axis}\b", body):
            continue
        for args in grids:
            arg = args[i] if len(args) > i else "1"
            assert re.fullmatch(r"\d+", arg) and int(arg) > 1 or \
                CLAMP.fullmatch(arg), (
                    f"{src}: {kernel} reads blockIdx.{axis} or "
                    f"gridDim.{axis}, launched with {axis} = {arg}")


def test_grid_error_code_is_the_wrappers():
    # the wrappers raise ValueError on the code the C entries return for a
    # grid past grid x's 2^31 - 1 (sm90::kErrGrid)
    header = (CSRC / "sm90.cuh").read_text()
    m = re.search(r"constexpr int kErrGrid = (\d+);", header)
    assert m and int(m.group(1)) == attention._ERR_GRID
    with pytest.raises(ValueError, match="too large for one launch"):
        attention._check_launch("flash_fwd", attention._ERR_GRID,
                                lambda code: b"grid x's limit")
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        attention._check_launch("flash_fwd", 2, lambda code: b"oom")
    attention._check_launch("flash_fwd", 0, None)


def fast_div(d):
    """(m, s) of ``sm90::fast_div(d)``: m = ceil(2^(31 + l) / d), s = l - 1,
    l = ceil(log2 d); m = 0 for d = 1."""
    l = (d - 1).bit_length()
    if l == 0:
        return 0, 0
    return ((1 << (31 + l)) + d - 1) // d, l - 1


def div_by(x, m, s):
    """``sm90::div_by``: umulhi(x, m) >> s, x itself where m = 0."""
    x = np.asarray(x, np.uint64)
    return x if m == 0 else ((x * np.uint64(m)) >> np.uint64(32)) >> \
        np.uint64(s)


@pytest.mark.parametrize("lo,hi", [(1, 1 << 12), (1 << 12, 1 << 16),
                                   (65535, 65538)])
def test_fast_div_is_integer_division(lo, hi):
    # every divisor in [lo, hi), at the dividends' edges (0, d - 1, d, the
    # top of the range, 2^31 - 1) and at 64 random ones below 2^31
    rng = np.random.default_rng(lo)
    top = (1 << 31) - 1
    for d in range(lo, hi):
        m, s = fast_div(d)
        assert m < 1 << 32
        x = np.concatenate([[0, d - 1, d, d + 1, top - d, top - 1, top],
                            rng.integers(0, top, 64, endpoint=True)])
        assert np.array_equal(div_by(x, m, s), x // d), d


def test_fast_div_at_large_divisors():
    # divisors up to 2^31 - 1 (a grid's blocks or B * H) and powers of two
    rng = np.random.default_rng(7)
    top = (1 << 31) - 1
    ds = [int(d) for d in rng.integers(1, top, 2000, endpoint=True)]
    ds += [(1 << k) + e for k in range(31) for e in (-1, 0, 1)
           if 1 <= (1 << k) + e <= top]
    for d in ds:
        m, s = fast_div(d)
        assert m < 1 << 32
        x = np.concatenate([[0, d - 1, d, top - 1, top],
                            rng.integers(0, top, 256, endpoint=True)])
        assert np.array_equal(div_by(x, m, s), x // d), d

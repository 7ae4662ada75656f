"""PyTorch port: which kernel a problem shape takes, decided on the CPU.

Both kernel-bearing modules of the port choose between two routes from the
shapes alone — a lane's state in shared memory where it fits, one thread per
lane with the state in device memory where it does not — and never from a
failure. The rule is one pure function per module (``solve_route``), fed by a
byte count per lane (``state_bytes_per_lane``, ``factor_bytes_per_lane``)
that must equal what the CUDA source carves out of dynamic shared memory. The
sources keep that carve-up in one X-macro table each; these tests parse the
tables and hold the Python formulas to them, so the two cannot drift apart
unnoticed (on the card the wrappers also compare with the library's own count
before the first launch). No kernel runs here.
"""
import pathlib
import re

import pytest
import torch

from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk
from torch_kernel_util import misaligned

CSRC = pathlib.Path(ak.SOURCE).parent


def _define(text, name):
    m = re.search(rf"^#define\s+{name}\s+(.+?)\s*(?://.*)?$", text, re.M)
    assert m, f"#define {name} not found"
    return m.group(1)


def _table(text, name):
    """The entries X(name, floats[, flag]) of the X-macro table `name`."""
    m = re.search(rf"#define\s+{name}\(X\)\s*\\\n((?:.*\\\n)*.*\n)", text)
    assert m, f"table {name} not found"
    body = re.sub(r"/\*.*?\*/", "", m.group(1))
    rows = re.findall(r"X\(\s*(\w+)\s*,\s*([^,()]+(?:\([^()]*\)[^,()]*)*)\s*(?:,\s*([01])\s*)?\)", body)
    assert rows, f"table {name} is empty"
    return [(n, expr.strip(), flag == "1") for n, expr, flag in rows]


def _c_int(expr, env):
    """Evaluate a C integer expression of the tables (+, -, *, /, parentheses)."""
    assert re.fullmatch(r"[\w\s+\-*/()]+", expr), expr
    return int(eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(env)))


def _admm_bytes_from_source(Kst, nz, nc, shared_hjk):
    text = (CSRC / "admm_kernel.cu").read_text()
    align = int(_define(text, "SMEM_ALIGN_FLOATS"))
    env = dict(NZ=nz, NC=nc, Kst=Kst, N=Kst - 1)
    env["NTRI"] = _c_int(_define(text, "NTRI"), env)
    env["FREC"] = _c_int(_define(text, "FREC"), env)
    total = 0
    for _, expr, per_lane_hjk_only in _table(text, "SMEM_LANE_ARRAYS"):
        if per_lane_hjk_only and shared_hjk:
            continue
        total += -(-_c_int(expr, env) // align) * align
    return 4 * total


def _btridiag_bytes_from_source(K, nz):
    text = (CSRC / "btridiag_kernel.cu").read_text()
    align = int(_define(text, "BT_SMEM_ALIGN_FLOATS"))
    env = dict(NZ=nz, K=K)
    env["NTRI"] = _c_int(_define(text, "NTRI"), env)
    env["BT_FREC"] = _c_int(_define(text, "BT_FREC"), env)
    total = sum(-(-_c_int(expr, env) // align) * align
                for _, expr, _ in _table(text, "BT_SMEM_LANE_ARRAYS"))
    return 4 * total


@pytest.mark.parametrize("shared_hjk", [True, False], ids=["shared-HJK", "per-lane-HJK"])
@pytest.mark.parametrize("shape", [(51, 4, 2), (9, 4, 2), (21, 3, 1), (1001, 4, 2), (33, 6, 3), (21, 6, 4)],
                         ids=lambda s: "Kst{}_nz{}_nc{}".format(*s))
def test_state_bytes_per_lane_equals_the_cuda_carve_up(shape, shared_hjk):
    Kst, nz, nc = shape
    assert ak.state_bytes_per_lane(Kst, nz, nc, shared_hjk) == _admm_bytes_from_source(
        Kst, nz, nc, shared_hjk)


def test_state_bytes_at_the_flagship_shapes():
    """Config 1 (Kst=51, nz=4, nc=2): eight stage vectors of 204 floats, two
    interval vectors of 100, 51 records of 16 floats, 50 blocks of 16, and
    2 x 400 more for a lane's own J and K."""
    shared = 4 * (8 * 204 + 2 * 100 + 51 * 16 + 50 * 16)
    assert ak.state_bytes_per_lane(51, 4, 2, True) == shared == 13792
    assert ak.state_bytes_per_lane(51, 4, 2, False) == shared + 4 * 800
    assert ak.resident_lanes_per_sm(51, 4, 2, True) == 16
    assert ak.resident_lanes_per_sm(51, 4, 2, False) == 12


@pytest.mark.parametrize("shape", [(51, 4), (7, 3), (1001, 4), (1, 4), (13, 6)],
                         ids=lambda s: "K{}_nz{}".format(*s))
def test_factor_bytes_per_lane_equals_the_cuda_carve_up(shape):
    K, nz = shape
    assert bk.factor_bytes_per_lane(K, nz) == _btridiag_bytes_from_source(K, nz)


def _k3_scratch_bytes_from_source(K, nz):
    text = (CSRC / "btridiag_kernel.cu").read_text()
    env = dict(NZ=nz, K=K)
    env["NTRI"] = _c_int(_define(text, "NTRI"), env)
    return 4 * sum(_c_int(expr, env) for _, expr, _ in _table(text, "K3_SCRATCH_LANE_ARRAYS"))


@pytest.mark.parametrize("shape", [(51, 4), (7, 3), (1001, 4), (1, 4), (13, 6)],
                         ids=lambda s: "K{}_nz{}".format(*s))
def test_scratch_bytes_per_lane_equals_the_cuda_carve_up(shape):
    """K3's scratch: the wrapper's byte count against the table the kernel
    carves its lane's arrays by (tile-major, no padding between arrays)."""
    K, nz = shape
    assert bk.scratch_bytes_per_lane(K, nz) == _k3_scratch_bytes_from_source(K, nz)


def test_scratch_at_the_flagship_shapes():
    """K=51, nz=4: diagonal factors 2,040 B, sub-diagonal 3,200 B, z 816 B a
    lane; tiles of one warp, as the layout module's."""
    assert bk.scratch_bytes_per_lane(51, 4) == 2040 + 3200 + 816 == 6056
    text = (CSRC / "btridiag_kernel.cu").read_text()
    assert int(_define(text, "K3_TILE")) == bk.LANE_TILE == 32


def test_tables_name_what_the_source_notes_say():
    names = [n for n, _, _ in _table((CSRC / "admm_kernel.cu").read_text(), "SMEM_LANE_ARRAYS")]
    assert names == ["x", "zb", "yb", "xt", "gs", "lo", "hi", "rb", "cs", "yd", "Lf", "Lo",
                     "Jl", "Kl"]
    names = [n for n, _, _ in _table((CSRC / "btridiag_kernel.cu").read_text(),
                                     "BT_SMEM_LANE_ARRAYS")]
    assert names == ["Lf", "Lo", "z"]
    names = [n for n, _, _ in _table((CSRC / "btridiag_kernel.cu").read_text(),
                                     "K3_SCRATCH_LANE_ARRAYS")]
    assert names == ["Ld", "Lo", "z"]


@pytest.mark.parametrize("case", [
    # (Kst, nz, nc, shared_hjk, route)
    (51, 4, 2, True, "smem"),      # config 1, LTI
    (51, 4, 2, False, "smem"),     # config 1 shapes, structure per lane
    (2, 4, 2, True, "smem"),
    (201, 4, 2, True, "smem"),
    (1001, 4, 2, True, "thread"),  # a horizon too long for shared memory
    (1001, 4, 2, False, "thread"),
    (401, 6, 3, False, "thread"),
], ids=lambda c: "Kst{}_nz{}_nc{}_{}".format(c[0], c[1], c[2], "shared" if c[3] else "perlane"))
def test_admm_shape_rule(case):
    Kst, nz, nc, shared, route = case
    assert ak.solve_route(Kst, nz, nc, shared) == route
    fits = ak.MIN_RESIDENT_LANES * ak.state_bytes_per_lane(Kst, nz, nc, shared)
    assert (fits <= ak.MAX_DYNAMIC_SMEM_BYTES) == (route == "smem")


def test_admm_shape_rule_is_monotone_in_the_horizon():
    routes = [ak.solve_route(Kst, 4, 2, True) for Kst in range(2, 1200, 7)]
    flip = routes.index("thread")
    assert set(routes[:flip]) == {"smem"} and set(routes[flip:]) == {"thread"}
    # per-lane J and K take shared memory of their own: the rule flips earlier
    flip_pl = [ak.solve_route(Kst, 4, 2, False) for Kst in range(2, 1200, 7)].index("thread")
    assert flip_pl <= flip


@pytest.mark.parametrize("case", [(51, 4, "smem"), (1, 4, "smem"), (7, 3, "smem"),
                                  (1001, 4, "thread"), (51, 40, "thread")],
                         ids=lambda c: "K{}_nz{}".format(c[0], c[1]))
def test_btridiag_shape_rule(case):
    K, nz, route = case
    assert bk.solve_route(K, nz) == route
    if nz <= 32:
        fits = bk.lanes_per_warp(nz) * bk.factor_bytes_per_lane(K, nz)
        assert (fits <= bk.MAX_DYNAMIC_SMEM_BYTES) == (route == "smem")


def test_both_modules_agree_on_the_card():
    assert ak.MAX_DYNAMIC_SMEM_BYTES == bk.MAX_DYNAMIC_SMEM_BYTES == 232448
    assert ak.ROUTES == bk.ROUTES == ("smem", "thread")
    # the team size is a compile-time constant of the source
    assert 32 // int(_define((CSRC / "admm_kernel.cu").read_text(), "TEAM")) == ak.LANES_PER_WARP
    assert bk.lanes_per_warp(4) == 8 and bk.lanes_per_warp(3) == 10


def test_the_quotient_helper_is_one_text_in_both_sources():
    """Both sources build a / b from the reciprocal of b with the one
    function of ``quotient.cuh``; the card checks it against the division."""
    header = (CSRC / "quotient.cuh").read_text()
    assert "float quotient(float a, float b, float y, bool& bad)" in header
    assert "-use_fast_math" in header  # says which flags void the equality
    for path in ("admm_kernel.cu", "btridiag_kernel.cu"):
        text = (CSRC / path).read_text()
        assert '#include "quotient.cuh"' in text and "quotient<" in text
        assert "float quotient(" not in text and "void load_floats(" not in text


def _qp_args(B=3, Kst=5, nz=4, nc=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    N = Kst - 1
    A = r(B, Kst, nz, nz) * 0.3
    Hd = A @ A.transpose(-1, -2) + 2.0 * torch.eye(nz)
    dlb, dub = torch.full((B, Kst, nz), -0.7), torch.full((B, Kst, nz), 0.7)
    dlb[:, 0, :2] = dub[:, 0, :2] = 0.0
    z = torch.zeros(B, Kst, nz)
    return [Hd, r(B, N, nc, nz) * 0.5, r(B, N, nc, nz) * 0.5, r(B, Kst, nz), r(B, N, nc) * 0.1,
            dlb, dub, torch.full((B,), 0.1), z, torch.clamp(z, dlb, dub),
            torch.zeros(B, N, nc), z.clone()]


@pytest.mark.parametrize("route", [None, "smem", "thread"])
@pytest.mark.parametrize("operands", ["contiguous", "strided", "broadcast"])
def test_admm_wrappers_on_the_cpu_return_the_plain_versions_bits(operands, route):
    """On CPU tensors the route is never consulted: contiguous, strided and
    broadcast operands all give the plain version's bits."""
    args = _qp_args()
    if operands == "strided":
        args = [a.transpose(0, 1).contiguous().transpose(0, 1) if a.dim() > 1 else a for a in args]
        assert not args[3].is_contiguous()
    if operands == "broadcast":
        args[:3] = [a[0].expand(a.shape) for a in args[:3]]
        assert args[0].stride(0) == 0
    base = dict(sigma=1e-6, alpha=1.6, rho_eq_scale=1e3)
    kw = dict(base, n_rounds=3, iters=4, tol=1e-5, rho_min=1e-4, rho_max=1e4)
    ak.reset_launch_counts()
    for got, want in zip(ak.boxqp_solve(*args, **kw, route=route),
                         ak.boxqp_solve_plain(*[a.contiguous() for a in args], **kw)):
        assert torch.equal(got, want)
    for got, want in zip(ak.admm_round(*args, iters=3, **base, route=route),
                         ak.admm_round_plain(*[a.contiguous() for a in args], iters=3, **base)):
        assert torch.equal(got, want)
    assert ak.LAUNCHES == {"boxqp_solve": 0, "admm_round": 0}


@pytest.mark.parametrize("route", [None, "smem", "thread"])
@pytest.mark.parametrize("operands", ["contiguous", "strided", "broadcast"])
def test_btridiag_wrapper_on_the_cpu_returns_the_plain_versions_bits(operands, route):
    g = torch.Generator().manual_seed(1)
    B, K, nz = 4, 6, 3
    A = torch.randn(B, K, nz, nz, generator=g)
    D = A @ A.transpose(-1, -2) + 8.0 * torch.eye(nz)
    O = 0.2 * torch.randn(B, K - 1, nz, nz, generator=g)
    b = torch.randn(B, K, nz, generator=g)
    if operands == "strided":
        D, O, b = (a.transpose(0, 1).contiguous().transpose(0, 1) for a in (D, O, b))
    if operands == "broadcast":
        D, O = D[0].expand(D.shape), O[0].expand(O.shape)
    bk.reset_launch_counts()
    got = bk.btridiag_factor_solve(D, O, b, route=route)
    assert torch.equal(got, bk.btridiag_factor_solve_plain(D.contiguous(), O.contiguous(),
                                                           b.contiguous()))
    assert bk.LAUNCHES == {"btridiag_factor_solve": 0, "btridiag_factor_solve_inplace": 0}


def test_an_unknown_route_is_refused():
    args = _qp_args()
    with pytest.raises(ValueError, match="route"):
        ak._pick_route("boxqp_solve", "tensor-core", 5, 4, 2, False)
    with pytest.raises(ValueError, match="fit"):
        ak._pick_route("boxqp_solve", "smem", 1001, 4, 2, False)
    assert ak._pick_route("boxqp_solve", None, 1001, 4, 2, False) == "thread"
    assert ak._pick_route("admm_round", "thread", 51, 4, 2, True) == "thread"
    with pytest.raises(ValueError, match="route"):
        bk.btridiag_factor_solve(args[0][:, :, :3, :3], args[0][:, :-1, :3, :3],
                                 args[3][:, :, :3], route="warp")


@pytest.mark.parametrize("case", ["contiguous", "broadcast", "strided-lanes", "transposed",
                                  "single-lane"])
def test_operands_reach_the_shared_memory_kernels_without_needless_copies(case):
    """What the shared-memory route hands to its kernels (Python the CPU can
    reach): a contiguous operand is passed as it is, a broadcast one as its
    single copy, lanes a stride apart keep their stride, and only a view whose
    lanes are not contiguous is copied."""
    a = torch.randn(6, 5, 3, 3)
    if case == "contiguous":
        out, stride = bk._lane_strided(a)
        assert out.data_ptr() == a.data_ptr() and stride == 45
    elif case == "broadcast":
        out, stride = bk._lane_strided(a[0].expand(a.shape))
        assert stride == 0 and out.shape == a.shape[1:] and out.data_ptr() == a.data_ptr()
    elif case == "strided-lanes":
        out, stride = bk._lane_strided(a[::2])
        assert out.data_ptr() == a.data_ptr() and stride == 90
    elif case == "transposed":
        v = a.transpose(2, 3)
        out, stride = bk._lane_strided(v)
        assert out.is_contiguous() and stride == 45 and torch.equal(out, v)
    else:
        out, stride = bk._lane_strided(a[:1])
        assert out.data_ptr() == a.data_ptr() and stride == 0
    args = _qp_args()
    ops, shared = ak._batch_first_operands(args)
    assert not shared and all(o.data_ptr() == x.data_ptr() for o, x in zip(ops, args))
    args[:3] = [x[0].expand(x.shape) for x in args[:3]]
    ops, shared = ak._batch_first_operands(args)
    assert shared and [tuple(o.shape) for o in ops[:3]] == [tuple(x.shape[1:]) for x in args[:3]]
    assert all(o.is_contiguous() for o in ops)


class _RecordingLib:
    """Stands in for the loaded library: records what the wrapper hands to
    K3's launcher and launches nothing."""

    def __init__(self):
        self.calls = []

    def btridiag_scratch_floats_per_lane(self, K):
        return bk.scratch_bytes_per_lane(K, 4) // 4

    def btridiag_factor_solve_scratch_launch(self, p, B, K, sD, sO, sb, info, stream):
        self.calls.append(dict(ptrs=[p[i] for i in range(5)], strides=(sD, sO, sb)))
        return 0


@pytest.mark.parametrize("case", ["contiguous", "broadcast", "strided-lanes", "single-lane",
                                  "transposed-b", "misaligned"])
def test_k3_is_handed_the_callers_tensors_without_a_copy(case):
    """What K3's launch hands to its kernel: the caller's own tensors (a
    broadcast D or O as its one copy, lanes a stride apart with their
    stride), no layout conversion; only a view whose lanes are not contiguous
    or not 16-byte aligned is copied, once, and x and the scratch are fresh."""
    B, K, nz = 6, 5, 4
    D, O, b = torch.randn(B, K, nz, nz), torch.randn(B, K - 1, nz, nz), torch.randn(B, K, nz)
    if case == "broadcast":
        D, O = D[0].expand(D.shape), O[0].expand(O.shape)
    elif case == "strided-lanes":
        D, O, b = D[::2], O[::2], b[::2]
    elif case == "single-lane":
        D, O, b = D[:1], O[:1], b[:1]
    elif case == "transposed-b":
        b = b.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "misaligned":
        D, O, b = (misaligned(a) for a in (D, O, b))
    lanes = D.shape[0]
    lib = _RecordingLib()
    x = bk._launch_scratch(lib, D, O, b, (lanes, K, nz), 0)
    (call,) = lib.calls
    assert x.shape == (lanes, K, nz) and x.is_contiguous()
    assert call["ptrs"][3] == x.data_ptr() and call["ptrs"][4] not in call["ptrs"][:4]
    assert all(p % 16 == 0 for p in call["ptrs"])
    sD, sO, sb = call["strides"]
    if case in ("contiguous", "broadcast", "strided-lanes", "single-lane"):
        assert call["ptrs"][:3] == [a.data_ptr() for a in (D, O, b)]
    if case == "contiguous":
        assert (sD, sO, sb) == (K * nz * nz, (K - 1) * nz * nz, K * nz)
    elif case == "broadcast":
        assert (sD, sO, sb) == (0, 0, K * nz)
    elif case == "strided-lanes":
        assert (sD, sO, sb) == (2 * K * nz * nz, 2 * (K - 1) * nz * nz, 2 * K * nz)
    elif case == "single-lane":
        assert (sD, sO, sb) == (0, 0, 0)
    elif case == "transposed-b":
        assert call["ptrs"][:2] == [D.data_ptr(), O.data_ptr()] and call["ptrs"][2] != b.data_ptr()
        assert sb == K * nz
    else:
        assert not set(call["ptrs"][:3]) & {a.data_ptr() for a in (D, O, b)}
        assert (sD, sO, sb) == (K * nz * nz, (K - 1) * nz * nz, K * nz)
    info = bk.LAUNCH_INFO["btridiag_factor_solve"]
    assert info["route"] == "scratch" and info["threads_per_lane"] == 1
    assert info["scratch_bytes_per_lane"] == bk.scratch_bytes_per_lane(K, nz)

"""The port's relational kernel function against the JAX package's.

The plain PyTorch version (``repro_torch.kernels.relational``) must be
bit-identical — no tolerance — to the reference package's Pallas kernel
(``repro.kernels.relational.build_elementwise``, run in interpret mode in
float64 under a scoped ``jax.enable_x64``) running test-written JAX bodies
of the same program, and to the reference ``eval_pred`` / ``eval_linexpr``.
The JAX bodies follow the reference plane's two-program split (products,
then sums and compares) so XLA has nothing to contract into an FMA.  The
one allowed difference from the JAX kernel is the sign bit of a NaN (see
``_same_bits_but_nan_sign``); against numpy even NaN bits must agree.

The CUDA kernel itself runs only on a GPU: its tests are in
``tests/test_torch_relational_cuda.py`` and ``tests/test_torch_isolation.py``
(``cuda`` marker), which import no JAX so that they also run where JAX is
not installed.  The CPU tests here also pin what decides the kernel's
instance (``route``) and the plan layout the CUDA source decodes.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.api.serialize import encode_value
from repro.core.predicates import LinCmp, LinExpr, NonLinearAtom, Pred, StrEq
from repro.engine.ops_impl import eval_linexpr, eval_pred
from repro.engine.table import Table as RTable
from repro.kernels.relational import build_elementwise
from repro_torch.api.serialize import decode_value
from repro_torch.engine.plane.torch_plane import TorchPlane
from repro_torch.engine.table import Table
from repro_torch.kernels import relational as R

SIZES = (0, 1, 7, 1024, 1025, 4097)

_SPECIAL = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-12, -1e-12,
                     np.nextafter(1e-12, 1.0), np.nextafter(-1e-12, -1.0),
                     np.nextafter(1e-12, 0.0), 0.1, 0.2, 0.3, 1e15, -1e15])


def _columns(n, seed):
    """a, b float64 and c int64, salted with NaN, +-0, +-inf and values
    that land exactly on the +-1e-12 bands."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1e6, 1e6, n)
    b = rng.uniform(-1e6, 1e6, n)
    c = rng.integers(-(2**53) - 8, 2**53 + 8, n, dtype=np.int64)
    s = rng.choice(np.array(["u", "v", "w"], dtype=object), n)
    if n:
        k = max(1, n // 6)
        a[rng.integers(0, n, k)] = rng.choice(_SPECIAL, k)
        b[rng.integers(0, n, k)] = rng.choice(_SPECIAL, k)
        c[rng.integers(0, n, k)] = rng.integers(-3, 4, k)
        m = rng.integers(0, n, k)
        b[m] = a[m]
        a[rng.integers(0, n, k)] = 1e-12
    return {"a": a, "b": b, "c": c, "s": s}


E1 = LinExpr.make({"a": Fraction(5, 2), "b": Fraction(-7, 4)}, Fraction(1, 3))
E2 = LinExpr.make({"b": Fraction(1, 3), "c": 2}, Fraction(-1, 2))
E3 = LinExpr.make({"a": 1, "b": -1}, 0)
E4 = LinExpr.make({"a": 1}, Fraction(-1, 10**12))

PREDS = {
    "le": Pred.of(LinCmp(E1, "<=")),
    "lt": Pred.of(LinCmp(E2, "<")),
    "eq": Pred.of(LinCmp(E3, "==")),
    "ne": Pred.of(LinCmp(E4, "!=")),
    "and_not": Pred.and_(Pred.of(LinCmp(E1, "<=")), Pred.not_(Pred.of(LinCmp(E2, "<")))),
    "or_nested": Pred.or_(
        Pred.and_(Pred.of(LinCmp(E3, "==")), Pred.of(LinCmp(E4, "!="))),
        Pred.not_(Pred.or_(Pred.of(LinCmp(E1, "<")), Pred.of(LinCmp(E2, "<=")))),
    ),
    "host_atoms": Pred.or_(
        Pred.and_(Pred.of(LinCmp(E1, "<=")), Pred.of(StrEq("s", "v"))),
        Pred.of(NonLinearAtom("prod_pos", ("a", "b"))),
        Pred.and_(Pred.of(LinCmp(LinExpr.lit(1), "<=")), Pred.of(LinCmp(E3, "!="))),
    ),
    "true_false_leaves": Pred("and", children=(
        Pred.true(), Pred("or", children=(Pred.false(), Pred.of(LinCmp(E4, "<=")))),
    )),
    "single_child_and": Pred("and", children=(Pred.of(LinCmp(E2, "!=")),)),
}

PROJ = (("x", E1), ("y", E2), ("z", E3), ("k", LinExpr.lit(Fraction(7, 3))), ("a", "a"))


def _port(value):
    """A reference-package property value as the port's object."""
    return decode_value(encode_value(value))


# -- the same program as JAX bodies through the Pallas kernel ------------------


def _jax_products(program, cols):
    def mul_body(*arrs):
        return tuple(v * x.astype(jnp.float64) for (_, v), x in zip(program.prods, arrs))

    return build_elementwise(mul_body, impl="interpret")(
        *[cols[slot] for slot, _ in program.prods]
    )


def _jax_term(program, prods, t, shape):
    const, _, start, count = program.terms[t]
    out = jnp.full(shape, const, dtype=jnp.float64)
    for j in range(start, start + count):
        out = out + prods[j]
    return out


def _jax_mask(program, cols, hosts):
    n_prod = len(program.prods)

    def mask_body(*args):
        prods, host = args[:n_prod], args[n_prod:]
        m = prods[0].shape  # one (8, 128) block inside the Pallas kernel
        stack = []
        for op, arg in program.tree:
            if op == R.ATOM:
                v = _jax_term(program, prods, arg, m)
                code = program.terms[arg][1]
                stack.append(v <= 1e-12 if code == R.LE else v < -1e-12 if code == R.LT
                             else jnp.abs(v) <= 1e-12 if code == R.EQ else jnp.abs(v) > 1e-12)
            elif op == R.HOST:
                stack.append(host[arg])
            elif op in (R.TRUE, R.FALSE):
                stack.append(jnp.full(m, op == R.TRUE, dtype=bool))
            elif op == R.NOT:
                stack.append(~stack.pop())
            else:
                top = stack.pop()
                stack.append(stack.pop() & top if op == R.AND else stack.pop() | top)
        return stack.pop()

    prods = _jax_products(program, cols)
    return np.asarray(build_elementwise(mask_body, impl="interpret")(*prods, *hosts))


def _jax_values(program, cols):
    def val_body(*prods):
        m = prods[0].shape
        return tuple(_jax_term(program, prods, t, m) for t in range(len(program.terms)))

    prods = _jax_products(program, cols)
    return [np.asarray(v) for v in build_elementwise(val_body, impl="interpret")(*prods)]


def _same_bits(x, y):
    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    return x.shape == y.shape and x.tobytes() == y.tobytes()


def _same_bits_but_nan_sign(x, y):
    """Bit-identical, except that a NaN may carry either sign: XLA rewrites
    ``-1 * x`` as a negation, which flips a NaN's sign bit where IEEE
    multiplication (numpy's, the port's) returns the NaN operand unchanged."""
    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    if x.shape != y.shape or not np.array_equal(np.isnan(x), np.isnan(y)):
        return False
    keep = ~np.isnan(x)
    return x[keep].tobytes() == y[keep].tobytes()


# -- tests ---------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_plain_mask_matches_pallas_interpret_and_eval_pred(n):
    plane = TorchPlane(device="cpu")
    cols = _columns(n, seed=n)
    rt = RTable(cols, ["a", "b", "c", "s"])
    pt = Table(cols, ["a", "b", "c", "s"])
    with np.errstate(all="ignore"), jax.enable_x64(True):
        for name, pred in PREDS.items():
            plan = plane._compile_pred(_port(pred))
            assert plan is not None, name
            slots = [pt.cols[c] for c in plan.columns]
            hosts = [eval_pred(Pred.of(a), rt) for a in _host_atoms(pred)]
            got = R.relational(plan.program, [torch.from_numpy(x) for x in slots],
                               [torch.from_numpy(h) for h in hosts]).numpy()
            assert got.dtype == np.bool_ and got.shape == (n,)
            want = eval_pred(pred, rt)
            assert np.array_equal(got, want), name
            pallas = _jax_mask(plan.program, slots, hosts)
            assert np.array_equal(got, pallas), name


def _host_atoms(pred):
    """Host atoms of a reference predicate, in the order the plane scans them."""
    out = []

    def scan(p):
        if p.kind == "atom":
            a = p.atom
            if not (isinstance(a, LinCmp) and a.expr.coeffs):
                out.append(a)
        for c in p.children:
            scan(c)

    scan(pred)
    return out


@pytest.mark.parametrize("n", SIZES)
def test_plain_values_match_pallas_interpret_and_eval_linexpr(n):
    plane = TorchPlane(device="cpu")
    cols = _columns(n, seed=100 + n)
    rt = RTable(cols, ["a", "b", "c", "s"])
    plan = plane._compile_proj(_port(PROJ))
    slots = [cols[c] for c in plan.columns]
    with np.errstate(all="ignore"), jax.enable_x64(True):
        got = [v.numpy() for v in R.relational(plan.program, [torch.from_numpy(x) for x in slots])]
        pallas = _jax_values(plan.program, slots)
        for name, kind, ti in plan.items:
            if kind != "lin":
                continue
            want = eval_linexpr(dict(PROJ)[name], rt)
            assert _same_bits(got[ti], want), name
            assert _same_bits_but_nan_sign(got[ti], pallas[ti]), name


def test_int64_columns_convert_like_numpy():
    # int64 beyond 2**53 rounds to nearest-even on the way to float64
    c = np.array([2**53 + 1, 2**53 + 3, -(2**53) - 1, 7, -7], dtype=np.int64)
    program = R.RelProgram(1, ((0, 0.5),), ((0.25, R.VALUE, 0, 1),))
    got = R.relational(program, [torch.from_numpy(c)])[0].numpy()
    assert _same_bits(got, np.full(5, 0.25) + 0.5 * c.astype(np.float64))


def test_wrapper_routes_by_device_and_counts_only_launches():
    program = R.RelProgram(1, ((0, 2.0),), ((1.0, R.LE, 0, 1),), ((R.ATOM, 0),))
    x = torch.tensor([-1.0, 0.0, -0.5])
    before = R.relational.launches
    assert R.relational(program, [x]).tolist() == [True, False, True]
    assert R.relational.launches == before  # the plain version is no launch
    with pytest.raises(ValueError):
        R.relational(program, [torch.empty(3, dtype=torch.float64, device="meta")])
    with pytest.raises(ValueError):
        R.relational(program, [])


def test_program_depth_is_checked_at_launch():
    tree = tuple([(R.TRUE, 0)] * (R.MAX_DEPTH + 1) + [(R.AND, 0)] * R.MAX_DEPTH)
    deep = R.RelProgram(1, ((0, 1.0),), ((0.0, R.LE, 0, 1),), tree)
    assert deep.depth() == R.MAX_DEPTH + 1
    with pytest.raises(ValueError, match="stack"):
        R._launch(deep, [torch.zeros(3, dtype=torch.float64)], [])
    assert R.RelProgram(1, ((0, 1.0),), ((0.0, R.LE, 0, 1),), ((R.ATOM, 0),)).depth() == 1


def test_pack_lays_out_the_plan_as_the_kernel_reads_it():
    """Header of counts and offsets, then pointers, int flags, products,
    terms and program steps (csrc/relational.cu decodes this layout)."""
    program = R.RelProgram(
        2, ((0, 0.5), (1, -2.0), (1, 3.0)), ((0.25, R.LE, 0, 2), (-1.0, R.NE, 2, 1)),
        ((R.ATOM, 0), (R.HOST, 0), (R.AND, 0), (R.ATOM, 1), (R.OR, 0)), 1,
    )
    cols = [torch.zeros(4, dtype=torch.float64), torch.zeros(4, dtype=torch.int64)]
    hosts = [torch.zeros(4, dtype=torch.bool)]
    outs = [torch.zeros(4, dtype=torch.bool)]
    w = R._pack(program, cols, hosts, outs)
    head = dict(zip(R._HEADER, w[:len(R._HEADER)].tolist()))
    assert (head["n_terms"], head["n_prog"]) == (2, 5)
    assert head["default_nan"] == R.host_default_nan()
    assert w[head["col"]:head["col"] + 2].tolist() == [t.data_ptr() for t in cols]
    assert w[head["is_int"]:head["is_int"] + 2].tolist() == [0, 1]
    assert w[head["host"]] == hosts[0].data_ptr() and w[head["out"]] == outs[0].data_ptr()
    prods = w[head["prod"]:head["term"]].reshape(-1, 2)
    assert prods[:, 0].tolist() == [0, 1, 1]
    assert prods[:, 1].view(np.float64).tolist() == [0.5, -2.0, 3.0]
    terms = w[head["term"]:head["prog"]].reshape(-1, 4)
    assert terms[:, 0].view(np.float64).tolist() == [0.25, -1.0]
    assert terms[:, 1:].tolist() == [[R.LE, 0, 2], [R.NE, 2, 1]]
    assert w[head["prog"]:].reshape(-1, 2).tolist() == [list(s) for s in program.tree]


def _program_of_words(words):
    """A one-column mask program whose packed plan is ``words`` long: one
    atom of k products (19 + 2k words), and with a host mask and-ed in
    (24 + 2k) for an even length."""
    hosts = 1 - words % 2
    k = (words - (24 if hosts else 19)) // 2
    tree = ((R.ATOM, 0), (R.HOST, 0), (R.AND, 0)) if hosts else ((R.ATOM, 0),)
    program = R.RelProgram(1, ((0, 0.5),) * k, ((0.0, R.LE, 0, k),), tree, hosts)
    assert R.plan_words(program) == words
    return program


def _chip_smoke():
    """The repository root's chip_smoke.py as a module (its imports of the
    port are inside its functions)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("words, want", [(35, "param"), (127, "param"), (128, "param"),
                                         (129, "device"), (4081, "device")])
def test_route_follows_the_parameter_capacity(words, want):
    assert R.route(_program_of_words(words)) == want


def test_route_of_the_main_path_and_the_large_programs():
    """The hot chain's filter rides in the launch's parameters (35 words);
    the chip check's wide, deep and 240-atom filters and its 40-value
    projection go through device memory."""
    smoke = _chip_smoke()
    plane = TorchPlane(device="cpu")
    f1 = plane._compile_pred(smoke.hot_chain().ops["f1"].get("pred"))
    assert (R.plan_words(f1.program), R.route(f1.program)) == (35, "param")
    preds, proj = smoke._large_programs([f"a{i}" for i in range(17)])
    got = {name: (8 * R.plan_words(plane._compile_pred(p).program),
                  R.route(plane._compile_pred(p).program)) for name, p in preds.items()}
    assert got == {"wide": (14184, "device"), "deep": (9816, "device"),
                   "huge": (80984, "device")}
    assert R.route(plane._compile_proj(proj).program) == "device"


def test_param_capacity_matches_the_cuda_source():
    """The wrapper routes by the plan capacity csrc/relational.cu declares
    (the library itself checks only the header at load)."""
    import re
    from pathlib import Path

    src = (Path(R.__file__).resolve().parents[1] / "csrc" / "relational.cu").read_text()
    words = int(re.search(r"kParamWords = (\d+);", src).group(1))
    assert R.PARAM_WORDS == words and 8 * words == 1024


def test_cpu_calls_count_no_launch_of_any_instance():
    program = R.RelProgram(1, ((0, 2.0),), ((1.0, R.VALUE, 0, 1),))
    before = dict(R.relational.launches_by_instance)
    assert set(before) == set(R.ROUTES) == {"param", "device"}
    R.relational(program, [torch.arange(5, dtype=torch.float64)])
    R.relational(_program_of_words(4081), [torch.zeros(3, dtype=torch.float64)],
                 [torch.ones(3, dtype=torch.bool)])
    assert R.relational.launches_by_instance == before

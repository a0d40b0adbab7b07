"""paddle_tpu_torch's tensor surface as a whole against paddle_tpu, on the
CPU: the classification of every public name, the core (dtypes, places,
the generator, ``to_tensor``, the gradient switches), the autograd API and
``PyLayer``, ``framework.compat``, the ``device`` API, and a tiny Llama
decoder layer written once with the surface's names.

- (a) Every name of the JAX package's seven ops modules, its ``core``,
  ``autograd`` and ``framework.compat``, and the ``device`` names of this
  slice falls into exactly one of HELD, GRAD, RANDOM and LEFT
  (``tests/torch_surface_cases.py``); a new or missing name fails. LEFT is
  the list ROADMAP's long-tail item keeps, each name there.
- (c) The dtype map: the paddle names and aliases are torch dtypes; the
  64-bit names are 64-bit in the port, 32-bit in the JAX package (x64 off):
  ``float64``, ``int64`` and ``complex128``, and what ``to_tensor`` infers
  from python ints. ``finfo`` / ``iinfo`` equal the reference's records.
- (e) ``grad`` (``create_graph`` for a second derivative, ``allow_unused``),
  ``backward``, ``jacobian`` / ``hessian`` with and without ``batch_axis``
  (the reference computes the full Jacobian either way), ``no_grad`` as a
  decorator and a context, ``saved_tensors_hooks``, and two PyLayers (saved
  tensors and a non-tensor argument; a non-differentiable output), each
  through both packages.
- (f) ``decoder_layer(P, ...)`` uses only the surface's names; run with
  ``P=paddle_tpu`` and ``P=paddle_tpu_torch`` its output and input
  gradient agree within fp32 tolerance, and the port's run equals the
  port's own ``LlamaForCausalLM`` layer on the same weights.
- (g) The places: ``set_device`` / ``get_device`` / ``resolve_device``;
  with CUDA mocked away, creation on the default place raises the device
  policy's error, and after ``set_device("cpu")`` it lands on the CPU.

fp32 tolerance: rtol 1e-5, atol 1e-6; the decoder layer atol 1e-5 (its
attention sums 16 keys in other orders: the port's flash tiles, softmax).
"""
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as pt
import torch_surface_cases as cases
from paddle_tpu_torch.core import place

ROOT = Path(__file__).resolve().parent.parent
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def cpu_place_one_thread():
    """The CPU as the current place and one intra-op thread; both, and the
    generator's state, restored after every test (a test may set another
    place or seed)."""
    threads, prev = torch.get_num_threads(), place._current[0]
    state = pt.get_rng_state()
    torch.set_num_threads(1)
    place.set_device("cpu")
    yield
    pt.set_rng_state(state)
    place._current[0] = prev
    torch.set_num_threads(threads)


# -- (a) the classification --------------------------------------------------

_OPS = ("creation", "math", "manipulation", "logic", "search", "random",
        "linalg")
_ALL_MODULES = ("autograd", "framework.compat", "device", "device.cuda",
                "device.xpu", "core.random", "core.tensor", "core.autograd")
_PUBLIC_MODULES = ("core.dtype", "core.place")     # no __all__ there


def _public(mod):
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not inspect.ismodule(v)
                  and n != "annotations")


def _reference_surface():
    import importlib

    names = set()
    for m in _OPS + _ALL_MODULES + _PUBLIC_MODULES:
        mod = importlib.import_module(
            f"paddle_tpu.{'ops.' if m in _OPS else ''}{m}")
        key = f"ops.{m}" if m in _OPS else m
        names |= {f"{key}:{n}" for n in (
            _public(mod) if m in _PUBLIC_MODULES else mod.__all__)}
    return names


def _qualified(short_names):
    return {f"ops.{cases.MODULE_OF[n]}:{n}" for n in short_names}


def _checks():
    """qualified name -> the check of a core, autograd, compat or device
    name (defined below)."""
    out = {}
    for key, fn in CORE_CHECKS.items():
        mod, names = key
        for n in names.split():
            out[f"{mod}:{n}"] = fn
    return out


def test_surface_fully_classified():
    surface = _reference_surface()
    held = (_qualified(cases.HELD) | _qualified(cases.RECONSTRUCTED)
            | set(_checks()))
    grad = _qualified(cases.GRAD)
    rand = _qualified(cases.RANDOM)
    left = set(cases.LEFT)
    sets = {"HELD": held, "GRAD": grad, "RANDOM": rand, "LEFT": left}
    for a in sets:
        for b in sets:
            if a < b:
                assert not sets[a] & sets[b], (a, b, sets[a] & sets[b])
    known = held | grad | rand | left
    assert not surface - known, f"unclassified: {sorted(surface - known)}"
    assert not known - surface, f"not in the reference: {sorted(known - surface)}"


def test_every_name_but_left_is_in_the_port():
    import importlib

    for q in _reference_surface() - set(cases.LEFT):
        mod, name = q.split(":")
        port = importlib.import_module(f"paddle_tpu_torch.{mod}")
        assert hasattr(port, name), q
    for q in cases.LEFT:
        mod, name = q.split(":")
        assert not hasattr(importlib.import_module(f"paddle_tpu_torch.{mod}"),
                           name), q


def _roadmap_item(text):
    """The item of ROADMAP's queue A (a block that starts with its number,
    as ``A14d. **``) that mentions ``text``: found by its content, so a
    re-anchor that renumbers the queue does not move it."""
    roadmap = (ROOT / "ROADMAP.md").read_text()
    queue = roadmap[roadmap.index("\n### A. "):]
    queue = queue[:queue.index("\n### ", 1)]
    items = re.split(r"\n(?=A\d+[a-z]?\. \*\*)", queue)
    found = [item for item in items if text in item]
    assert len(found) == 1, (text, len(found))
    return found[0]


def test_left_is_the_roadmaps_list():
    a14 = _roadmap_item("`ops/_methods.py`")
    for q, reason in cases.LEFT.items():
        assert q.split(":")[1] in a14, q
        assert reason
    for name in ("_methods.py", "to_static", "enable_static",
                 "disable_static", "in_dynamic_mode", "op_hooks"):
        assert name in a14, name


def test_top_level_names():
    """The reference's top-level names of this slice (its dtypes, places,
    generator, tensor and gradient switches, the ops and its lazy
    attributes of this slice) are the port's, from the same modules."""
    ops = {n for m in _OPS for n in getattr(paddle_tpu, m).__all__}
    lazy = {"grad", "finfo", "iinfo", "dtype", "bool", "CUDAPinnedPlace",
            "batch", "LazyGuard", "check_shape", "disable_signal_handler",
            "set_printoptions", "tolist", "get_cuda_rng_state",
            "set_cuda_rng_state", "pow_", "index_add_", "index_put_",
            "scatter_", "squeeze_", "tanh_", "unsqueeze_", "synchronize",
            "ParamAttr"}
    assert lazy <= set(paddle_tpu._LAZY_ATTRS)
    core = {"bfloat16", "bool_", "complex64", "complex128", "float16",
            "float32", "float64", "get_default_dtype", "int8", "int16",
            "int32", "int64", "set_default_dtype", "uint8", "CPUPlace",
            "CUDAPlace", "TPUPlace", "device_count", "get_device",
            "is_compiled_with_cuda", "is_compiled_with_tpu", "set_device",
            "get_rng_state", "seed", "set_rng_state", "Tensor", "is_tensor",
            "to_tensor", "enable_grad", "no_grad", "set_grad_enabled",
            "is_grad_enabled", "linalg"}
    for n in sorted(ops | lazy | core):
        assert hasattr(paddle_tpu, n), n
        assert getattr(pt, n) is not None, n
    assert pt.linalg.lstsq is pt.lstsq
    assert pt.bool is torch.bool and pt.dtype is torch.dtype
    assert len(pt.__all__) == 16 and "get_device" in pt.__all__


def test_import_is_light():
    """``import paddle_tpu_torch`` initializes no CUDA and imports neither
    scipy nor the lazy subpackages."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch, paddle_tpu_torch as pt\n"
            "assert not torch.cuda.is_initialized()\n"
            "bad = [m for m in ('scipy', 'jax', 'paddle_tpu_torch.autograd',"
            " 'paddle_tpu_torch.serving') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "pt.grad\n"
            "assert 'paddle_tpu_torch.autograd' in sys.modules\n"
            "print('ok')" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]


# -- (c) dtypes -------------------------------------------------------------

_DTYPES = ("float16 bfloat16 float32 float64 int8 int16 int32 int64 uint8 "
           "uint16 uint32 bool_ complex64 complex128").split()
# the names the JAX package narrows to 32 bits while x64 is off
WIDENED = {"float64": "float32", "int64": "int32", "complex128": "complex64"}


def _jname(d):
    return jnp.dtype(d).name


def _pname(d):
    return str(d).removeprefix("torch.")


def check_dtype_names(name):
    d = getattr(pt.core.dtype, name)
    assert isinstance(d, torch.dtype)
    got, want = _pname(d), _jname(getattr(paddle_tpu.core.dtype, name))
    assert WIDENED.get(got, got) == want, (name, got, want)


def check_dtype_tuples(name):
    got = [_pname(d) for d in getattr(pt.core.dtype, name)]
    want = [_jname(d) for d in getattr(paddle_tpu.core.dtype, name)]
    assert [WIDENED.get(g, g) for g in got] == want


_ALIASES = list(paddle_tpu.core.dtype._NAME_TO_DTYPE)


def check_convert_dtype(name):
    c, j = pt.core.dtype, paddle_tpu.core.dtype
    for alias in _ALIASES + [np.float32, np.int64, "float64"]:
        got = _pname(c.convert_dtype(alias))
        # the reference keeps numpy's 64-bit dtypes as they are
        assert _jname(j.convert_dtype(alias)) in (got, WIDENED.get(got)), \
            alias
    assert c.convert_dtype(None) is None
    for bad in ("float8", "nope"):
        with pytest.raises(ValueError):
            c.convert_dtype(bad)
        with pytest.raises(ValueError):
            j.convert_dtype(bad)


def check_dtype_predicates(name):
    c, j = pt.core.dtype, paddle_tpu.core.dtype
    for alias in _ALIASES:
        got = getattr(c, name)(c.convert_dtype(alias))
        want = getattr(j, name)(j.convert_dtype(alias))
        if name == "dtype_name":
            assert WIDENED.get(got, got) == want, alias
        else:
            assert got == want, (name, alias)


def check_promote(name):
    for a, b in (("float16", "float32"), ("int32", "float32"),
                 ("bool", "int8"), ("bfloat16", "float16")):
        got = _pname(pt.core.dtype.promote(a, b))
        assert got == _jname(paddle_tpu.core.dtype.promote(
            paddle_tpu.core.dtype.convert_dtype(a),
            paddle_tpu.core.dtype.convert_dtype(b))), (a, b)


def check_to_numpy_dtype(name):
    for alias in ("float32", "int32", "bool", "float16", "uint8"):
        assert pt.core.dtype.to_numpy_dtype(alias) == \
            paddle_tpu.core.dtype.to_numpy_dtype(alias)
    with pytest.raises(TypeError):          # numpy has no bfloat16 here
        pt.core.dtype.to_numpy_dtype("bfloat16")


def check_default_dtype(name):
    assert pt.get_default_dtype() == torch.float32
    try:
        pt.set_default_dtype("float64")
        paddle_tpu.set_default_dtype("float32")
        assert pt.to_tensor(1.5).dtype == torch.float64
        assert pt.zeros([2]).dtype == torch.float64
        assert torch.get_default_dtype() == torch.float32   # torch's own
        for P in (pt, paddle_tpu):
            with pytest.raises(TypeError):
                P.set_default_dtype("int32")
    finally:
        pt.set_default_dtype("float32")
    assert pt.to_tensor(1.5).dtype == torch.float32


def check_finfo_iinfo(name):
    if name == "finfo":
        for d in ("float16", "bfloat16", "float32", "float64"):
            got, want = pt.finfo(d), paddle_tpu.finfo(d)
            for attr in ("bits", "eps", "min", "max", "tiny",
                         "smallest_normal", "resolution"):
                if d == "float64":                  # JAX: float32 (x64 off)
                    continue
                assert getattr(got, attr) == getattr(want, attr), (d, attr)
            assert got.dtype == d
        assert pt.finfo("float64").bits == 64
    else:
        for d in ("int8", "int16", "int32", "uint8", "int64"):
            got, want = pt.iinfo(d), paddle_tpu.iinfo(d)
            if d == "int64":
                assert got.bits == 64 and got.max == 2 ** 63 - 1
                continue
            assert (got.bits, got.min, got.max, got.dtype) == (
                want.bits, want.min, want.max, want.dtype), d


def test_to_tensor_infers_dtypes():
    for data in (1.5, [1.0, 2.0], 3, [1, 2], True, [True, False],
                 np.float32(2.0), np.arange(3, dtype=np.int32),
                 np.ones(2, np.float16)):
        got = _pname(pt.to_tensor(data).dtype)
        want = paddle_tpu.to_tensor(data).dtype.name
        assert WIDENED.get(got, got) == want, data
    assert pt.to_tensor(3).dtype == torch.int64          # 64-bit is real
    assert pt.to_tensor(np.ones(2)).dtype == torch.float64
    assert pt.to_tensor([1, 2], dtype="float32").dtype == torch.float32
    t = pt.to_tensor([1.0, 2.0], stop_gradient=False)
    assert t.requires_grad and t.is_leaf
    src = torch.ones(2, requires_grad=True)
    copy = pt.to_tensor(src)
    assert not copy.requires_grad and copy.data_ptr() != src.data_ptr()


# -- core: places, generator, tensor, gradient switches ---------------------

def check_places(name):
    assert pt.CPUPlace() == torch.device("cpu")
    assert pt.CUDAPlace(1) == torch.device("cuda", 1)
    assert pt.core.place.CUDAPinnedPlace() == torch.device("cpu")
    assert pt.core.place.Place is torch.device
    with pytest.raises(ValueError):
        pt.TPUPlace(0)
    assert paddle_tpu.CPUPlace() == paddle_tpu.CPUPlace(0)


def check_set_get_device(name):
    assert pt.set_device("cpu") == torch.device("cpu")
    assert pt.get_device() == "cpu:0"
    for bad in ("tpu", "xpu:0", "tpu:1"):
        with pytest.raises(ValueError):
            pt.set_device(bad)


def check_device_queries(name):
    assert pt.device_count() == torch.cuda.device_count()
    assert pt.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert pt.is_compiled_with_tpu() is False


def check_generator(name):
    g = pt.core.random.Generator(4)
    assert g.initial_seed() == 4
    a = torch.rand(3, generator=g.generator("cpu"))
    g.manual_seed(4)
    assert torch.equal(torch.rand(3, generator=g.generator("cpu")), a)
    state = g.get_state()
    b = torch.rand(3, generator=g.generator("cpu"))
    g.set_state(state)
    assert torch.equal(torch.rand(3, generator=g.generator("cpu")), b)
    assert pt.seed(9) is pt.core.random.default_generator
    assert paddle_tpu.seed(9) is paddle_tpu.core.random.default_generator
    assert pt.core.random.default_generator.initial_seed() == 9
    state = pt.get_rng_state()
    x = pt.rand([4])
    pt.set_rng_state(state)
    assert torch.equal(pt.rand([4]), x)


def check_tensor(name):
    assert pt.Tensor is torch.Tensor
    assert pt.is_tensor(pt.to_tensor([1.0])) and not pt.is_tensor([1.0])
    assert paddle_tpu.is_tensor(paddle_tpu.to_tensor([1.0]))


def check_grad_switches(name):
    for P in (pt, paddle_tpu):
        x = P.to_tensor(np.ones(2, np.float32), stop_gradient=False)

        @P.no_grad()
        def doubled(t):
            return t * 2

        assert P.is_grad_enabled()
        with P.no_grad():
            assert not P.is_grad_enabled()
            with P.enable_grad():
                assert P.is_grad_enabled()
        with P.set_grad_enabled(False):
            assert not P.is_grad_enabled()
        y = doubled(x)
        if P is pt:
            assert not y.requires_grad
        else:
            assert y.stop_gradient
        assert P.is_grad_enabled()


# -- (e) the autograd API ----------------------------------------------------

def _both(fn):
    """fn(P) for both packages, as numpy."""
    return (cases.to_np(fn(pt)), cases.to_np(fn(paddle_tpu)))


def _leaf(P, a):
    return P.to_tensor(np.asarray(a, np.float32), stop_gradient=False)


XA, XB = cases.n(3, 4), cases.n(3, 4)


def check_grad_fn(name):
    def f(P):
        x, y = _leaf(P, XA), _leaf(P, XB)
        loss = P.sum(x * y + P.exp(x) * P.sin(y))
        return P.grad(loss, [x, y])

    got, want = _both(f)
    cases.assert_same(got, want, what="grad")
    for P in (pt, paddle_tpu):            # the leaves' .grad stay empty
        x = _leaf(P, XA)
        P.grad(P.sum(x * x), [x])
        assert x.grad is None


def test_grad_create_graph_gives_the_second_derivative():
    x = _leaf(pt, XA[0])
    (g,) = pt.grad(pt.sum(x * x * x), [x], create_graph=True)
    (h,) = pt.grad(pt.sum(g), [x])
    jh = paddle_tpu.autograd.hessian(
        lambda t: paddle_tpu.sum(t * t * t), paddle_tpu.to_tensor(XA[0]))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh.value).sum(0),
                               **cases.TOL)


def test_grad_allow_unused():
    for P in (pt, paddle_tpu):
        x, z = _leaf(P, XA), _leaf(P, XB)
        gx, gz = P.grad(P.sum(x * 2.0), [x, z], allow_unused=True)
        assert gz is None
        np.testing.assert_allclose(cases.to_np(gx), np.full((3, 4), 2.0))
        x, z = _leaf(P, XA), _leaf(P, XB)
        with pytest.raises(RuntimeError):
            P.grad(P.sum(x * 2.0), [x, z])


def check_backward(name):
    def f(P):
        x = _leaf(P, XA)
        P.autograd.backward([P.sum(x * x)])
        return x.grad

    got, want = _both(f)
    cases.assert_same(got, want, what="backward")


def _jac_func(P):
    return lambda t: P.tanh(P.matmul(t, P.to_tensor(XB.T)))


def check_jacobian(name):
    for ba in (None, 0):
        got, want = _both(lambda P: P.autograd.jacobian(
            _jac_func(P), P.to_tensor(XA), batch_axis=ba))
        cases.assert_same(got, want, what=f"jacobian batch_axis={ba}")
        got, want = _both(lambda P: P.autograd.jacobian(
            lambda a, b: P.multiply(a, P.exp(b)),
            [P.to_tensor(XA[0]), P.to_tensor(XB[0])], batch_axis=ba))
        cases.assert_same(got, want, what=f"jacobian list batch_axis={ba}")


def check_hessian(name):
    for ba in (None, 0):
        got, want = _both(lambda P: P.autograd.hessian(
            lambda t: P.sum(P.exp(t) * t), P.to_tensor(XA[0]),
            batch_axis=ba))
        cases.assert_same(got, want, what=f"hessian batch_axis={ba}")
        got, want = _both(lambda P: P.autograd.hessian(
            lambda a, b: P.sum(a * a * b), [P.to_tensor(XA[0]),
                                            P.to_tensor(XB[0])],
            batch_axis=ba))
        cases.assert_same(got, want, what=f"hessian list batch_axis={ba}")


def _layers(P):
    class Cube(P.autograd.PyLayer):
        """x^3 * k with k a python number: saved tensors."""

        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            ctx.k = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * x * x * (3.0 * ctx.k)

    class ExpArgmax(P.autograd.PyLayer):
        """exp(x) and argmax(x), the index marked non-differentiable."""

        @staticmethod
        def forward(ctx, x):
            y = P.exp(x)
            idx = P.argmax(x, axis=-1)
            ctx.mark_non_differentiable(idx)
            ctx.set_materialize_grads(False)
            ctx.save_for_backward(y)
            return y, idx

        @staticmethod
        def backward(ctx, gy, gidx=None):
            (y,) = ctx.saved_tensor()
            return gy * y

    return Cube, ExpArgmax


W = cases.n(3, 4)


def check_pylayer(name):
    def run(P):
        cube, ea = _layers(P)
        x = _leaf(P, XA)
        y = cube.apply(x, 0.5)
        e, idx = ea.apply(x)
        loss = P.sum(y * P.to_tensor(W)) + P.sum(e)
        return y, e, idx, P.grad(loss, [x])

    got, want = _both(run)
    cases.assert_same(got, want, what="PyLayer")
    _, ea = _layers(pt)
    _, idx = ea.apply(_leaf(pt, XA))
    assert not idx.requires_grad
    x = pt.to_tensor(XA)                    # no input needs a gradient
    assert not _layers(pt)[0].apply(x, 2.0).requires_grad


def check_saved_tensors_hooks(name):
    def run(P):
        calls = {"pack": 0, "unpack": 0}

        def pack(t):
            calls["pack"] += 1
            return ("packed", t)

        def unpack(p):
            calls["unpack"] += 1
            return p[1]

        cube, _ = _layers(P)
        x = _leaf(P, XA)
        with P.autograd.saved_tensors_hooks(pack, unpack):
            y = cube.apply(x, 2.0)
        (g,) = P.grad(P.sum(y), [x])
        assert calls["pack"] >= 1 and calls["unpack"] >= 1, calls
        return g

    got, want = _both(run)
    cases.assert_same(got, want, what="saved_tensors_hooks")


# -- framework.compat --------------------------------------------------------

def check_compat(name):
    def reader():
        yield from range(7)

    for P in (pt, paddle_tpu):
        assert list(P.batch(reader, 3)()) == [[0, 1, 2], [3, 4, 5], [6]]
        assert list(P.batch(reader, 3, drop_last=True)()) == [
            [0, 1, 2], [3, 4, 5]]
        with P.LazyGuard() as g:
            assert g is not None
        P.check_shape([2, 3])
        with pytest.raises(TypeError):
            P.check_shape([2, "3"])
        assert P.disable_signal_handler() is None
    assert pt.tolist(pt.to_tensor([[1, 2], [3, 4]])) == paddle_tpu.tolist(
        paddle_tpu.to_tensor(np.array([[1, 2], [3, 4]])))
    assert pt.framework.compat.dtype is torch.dtype
    pt.set_printoptions(precision=3)
    try:
        assert "1.235" in repr(pt.to_tensor([1.23456]))
    finally:
        torch.set_printoptions(profile="default")


_INPLACE = {
    "pow_": lambda P, x: P.pow_(x, 2.0),
    "tanh_": lambda P, x: P.tanh_(x),
    "scatter_": lambda P, x: P.scatter_(
        x, P.to_tensor(np.array([0, 2], np.int64)),
        P.to_tensor(np.ones((2, 4), np.float32))),
    "index_add_": lambda P, x: P.index_add_(
        x, P.to_tensor(np.array([1, 1], np.int64)), 0,
        P.to_tensor(np.ones((2, 4), np.float32))),
    "index_put_": lambda P, x: P.index_put_(
        x, [P.to_tensor(np.array([0, 2], np.int64))],
        P.to_tensor(np.full((2, 4), 5.0, np.float32))),
    "squeeze_": lambda P, x: P.squeeze_(x, [0, 1]),
    "unsqueeze_": lambda P, x: P.unsqueeze_(x, [0, -1]),
}


def check_inplace_fn(name):
    """The function forms act in place, return their argument, and on a
    leaf that needs a gradient replace its value outside the graph (the
    reference's behaviour); on a tensor of the graph torch records them."""
    a = XA[None].copy() if name == "squeeze_" else XA.copy()
    got, want = _both(lambda P: _INPLACE[name](P, P.to_tensor(a.copy())))
    cases.assert_same(got, want, what=name)
    x = pt.to_tensor(a.copy())
    assert _INPLACE[name](pt, x) is x
    leaf = pt.to_tensor(a.copy(), stop_gradient=False)
    _INPLACE[name](pt, leaf)
    assert leaf.is_leaf and leaf.requires_grad
    if name == "tanh_":                      # through the graph
        x = _leaf(pt, XA)
        z = x * 3.0
        pt.tanh_(z)
        (g,) = pt.grad(pt.sum(z), [x])
        np.testing.assert_allclose(
            g.numpy(), 3.0 * (1 - np.tanh(3.0 * XA) ** 2), rtol=1e-5,
            atol=1e-6)


# -- the device API ----------------------------------------------------------

def check_device_api(name):
    d = pt.device
    assert d.get_all_custom_device_type() == []
    assert d.get_available_custom_device() == []
    assert "cpu" in d.get_all_device_type()
    assert d.get_available_device()[0] == "cpu"
    assert d.is_compiled_with_xpu() is False
    assert d.is_compiled_with_cinn() is True   # jit.to_static compiles
    assert d.is_compiled_with_rocm() == (torch.version.hip is not None)
    assert d.get_cudnn_version() == torch.backends.cudnn.version()
    for cls in (d.XPUPlace, d.IPUPlace):
        with pytest.raises(RuntimeError):
            cls(0)
    with pytest.raises(RuntimeError):
        d.xpu.synchronize()
    d.synchronize("cpu")                       # the CPU's work is done
    assert d.peaks is pt.device.peaks
    assert d.cuda.synchronize is not None


def check_cuda_api(name):
    """The CUDA calls are torch.cuda's (held on the card by chip_smoke.py's
    phase 9); here only what needs no card."""
    c = pt.device.cuda
    assert c.Stream is torch.cuda.Stream and c.Event is torch.cuda.Event
    assert pt.device.Stream is c.Stream
    assert c.stream_guard is torch.cuda.stream
    assert c.device_count() == torch.cuda.device_count()
    assert callable(getattr(c, name, None) or getattr(pt.device, name))


def check_create_parameter(name):
    """The same attr resolution as the reference's: the attr's
    initializer and flags, the default initializer, zeros for a bias,
    ``attr=False`` for none; the port's is an ``nn.Parameter`` on the
    current place."""
    def made(P, **kw):
        return P.create_parameter([2, 3], "float32", **kw)

    for kw in ({"default_initializer": "Constant"}, {"is_bias": True},
               {"attr": "ParamAttr"}):
        out = []
        for P in (pt, paddle_tpu):
            k = dict(kw)
            if k.get("default_initializer"):
                k["default_initializer"] = P.nn.initializer.Constant(0.7)
            if k.get("attr"):
                k["attr"] = P.ParamAttr(
                    name="cp", initializer=P.nn.initializer.Constant(-1.5),
                    trainable=False, learning_rate=0.5)
            p = made(P, **k)
            out.append((np.asarray(p.detach() if P is pt else p.value),
                        p.trainable, p.optimize_attr["learning_rate"]))
        np.testing.assert_array_equal(out[0][0], out[1][0])
        assert out[0][1:] == out[1][1:]
    p = made(pt, attr=pt.ParamAttr(name="named"))
    assert isinstance(p, pt.nn.Parameter) and p.name == "named"
    assert p.device.type == "cpu" and p.requires_grad
    assert made(pt, attr=False) is None


CORE_CHECKS = {
    ("core.dtype", " ".join(_DTYPES)): check_dtype_names,
    ("core.dtype", "FLOATING_DTYPES INTEGER_DTYPES"): check_dtype_tuples,
    ("core.dtype", "convert_dtype"): check_convert_dtype,
    ("core.dtype", "dtype_name is_floating_point is_integer"):
        check_dtype_predicates,
    ("core.dtype", "promote"): check_promote,
    ("core.dtype", "to_numpy_dtype"): check_to_numpy_dtype,
    ("core.dtype", "set_default_dtype get_default_dtype"):
        check_default_dtype,
    ("core.dtype", "finfo iinfo"): check_finfo_iinfo,
    ("core.place", "Place CPUPlace CUDAPlace CUDAPinnedPlace TPUPlace"):
        check_places,
    ("core.place", "set_device get_device"): check_set_get_device,
    ("core.place", "device_count is_compiled_with_cuda is_compiled_with_tpu"):
        check_device_queries,
    ("core.random", "Generator default_generator seed get_rng_state "
                    "set_rng_state"): check_generator,
    ("core.tensor", "Tensor to_tensor is_tensor"): check_tensor,
    ("core.autograd", "no_grad enable_grad set_grad_enabled "
                      "is_grad_enabled"): check_grad_switches,
    ("autograd", "no_grad enable_grad set_grad_enabled is_grad_enabled"):
        check_grad_switches,
    ("autograd", "grad"): check_grad_fn,
    ("autograd", "backward"): check_backward,
    ("autograd", "jacobian"): check_jacobian,
    ("autograd", "hessian"): check_hessian,
    ("autograd", "PyLayer PyLayerContext"): check_pylayer,
    ("autograd", "saved_tensors_hooks"): check_saved_tensors_hooks,
    ("framework.compat", "batch LazyGuard check_shape disable_signal_handler "
                         "set_printoptions tolist dtype"): check_compat,
    ("framework.compat", " ".join(_INPLACE)): check_inplace_fn,
    ("device", "get_device set_device"): check_set_get_device,
    ("device", "is_compiled_with_cuda is_compiled_with_tpu"):
        check_device_queries,
    ("device", "get_all_device_type peaks get_all_custom_device_type "
               "get_available_device get_available_custom_device "
               "is_compiled_with_xpu is_compiled_with_cinn "
               "is_compiled_with_rocm cuda xpu synchronize XPUPlace IPUPlace "
               "get_cudnn_version"): check_device_api,
    ("device", "Stream Event current_stream stream_guard set_stream"):
        check_cuda_api,
    ("device.cuda", "Stream Event current_stream synchronize device_count "
                    "empty_cache max_memory_allocated max_memory_reserved "
                    "memory_allocated memory_reserved stream_guard "
                    "get_device_properties get_device_name "
                    "get_device_capability"): check_cuda_api,
    ("device.xpu", "synchronize"): check_device_api,
    ("ops.creation", "create_parameter"): check_create_parameter,
}


@pytest.mark.parametrize("qname", sorted(_checks()))
def test_core_name(qname):
    fn = _checks()[qname]
    fn(qname.split(":")[1])


# -- (f) the slice as a whole: a tiny Llama decoder layer --------------------

def decoder_layer(P, x, w, cos, sin, n_heads, eps):
    """One Llama decoder layer (RMSNorm, q/k/v, rotate-half RoPE, causal
    softmax attention, o, RMSNorm, SwiGLU MLP, two residuals) with only the
    tensor surface's names. ``w`` maps names to weights ([in, out] for the
    linears), ``cos``/``sin`` are [S, D/2]. RMSNorm, RoPE and the softmax
    compute in fp32, as the port's kernels do; the products in x's dtype
    (the scores from fp32 q and k)."""
    dt = x.dtype
    b, s, h = x.shape
    d = h // n_heads

    def rms(t, g):
        tf = P.cast(t, "float32")
        y = tf * P.rsqrt(P.mean(P.multiply(tf, tf), axis=-1, keepdim=True)
                         + eps)
        return P.cast(y * P.cast(g, "float32"), dt)

    def rope(t):
        t1, t2 = P.split(P.cast(t, "float32"), 2, axis=-1)
        c = P.reshape(P.cast(cos, "float32"), [1, s, 1, d // 2])
        sn = P.reshape(P.cast(sin, "float32"), [1, s, 1, d // 2])
        return P.cast(P.concat([t1 * c - t2 * sn, t2 * c + t1 * sn],
                               axis=-1), dt)

    def heads(t):
        return P.transpose(P.reshape(t, [b, s, n_heads, d]), [0, 2, 1, 3])

    hn = rms(x, w["ln1"])
    q = rope(P.reshape(P.matmul(hn, w["wq"]), [b, s, n_heads, d]))
    k = rope(P.reshape(P.matmul(hn, w["wk"]), [b, s, n_heads, d]))
    q, k = P.transpose(q, [0, 2, 1, 3]), P.transpose(k, [0, 2, 1, 3])
    v = heads(P.matmul(hn, w["wv"]))
    scores = P.matmul(P.cast(q, "float32"), P.cast(k, "float32"),
                      transpose_y=True) * (1.0 / float(np.sqrt(d)))
    causal = P.cast(P.tril(P.ones([s, s], dtype="float32")), "bool")
    scores = P.where(causal, scores, P.full([s, s], -1e30, dtype="float32"))
    e = P.exp(scores - P.max(scores, axis=-1, keepdim=True))
    p = P.cast(e / P.sum(e, axis=-1, keepdim=True), dt)
    ctx = P.reshape(P.transpose(P.matmul(p, v), [0, 2, 1, 3]), [b, s, h])
    x = x + P.matmul(ctx, w["wo"])
    hn = rms(x, w["ln2"])
    g = P.matmul(hn, w["wg"])
    act = P.multiply(P.multiply(g, P.sigmoid(g)), P.matmul(hn, w["wu"]))
    return x + P.matmul(act, w["wd"])


def _layer_inputs():
    from paddle_tpu_torch import llama_config
    from paddle_tpu_torch.models.llama import _rope_cos_sin

    cfg = llama_config("tiny", num_hidden_layers=1)
    h, i = cfg.hidden_size, cfg.intermediate_size
    rng = np.random.RandomState(3)
    w = {k: (rng.randn(*shape) * 0.1).astype(np.float32) for k, shape in (
        ("wq", (h, h)), ("wk", (h, h)), ("wv", (h, h)), ("wo", (h, h)),
        ("wg", (h, i)), ("wu", (h, i)), ("wd", (i, h)))}
    w["ln1"] = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    w["ln2"] = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    x = rng.randn(2, 16, h).astype(np.float32)
    cos, sin = (t.numpy() for t in _rope_cos_sin(16, cfg.head_dim,
                                                 cfg.rope_theta,
                                                 torch.float32, "cpu"))
    return cfg, w, x, cos, sin


def _layer_run(P, cfg, w, x, cos, sin):
    xt = P.to_tensor(x, stop_gradient=False)
    wt = {k: P.to_tensor(v) for k, v in w.items()}
    out = decoder_layer(P, xt, wt, P.to_tensor(cos), P.to_tensor(sin),
                        cfg.num_attention_heads, cfg.rms_norm_eps)
    gw = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    (g,) = P.grad(P.sum(out * P.to_tensor(gw)), [xt])
    return out, g, gw


def test_decoder_layer_matches_the_jax_package():
    cfg, w, x, cos, sin = _layer_inputs()
    got = _layer_run(pt, cfg, w, x, cos, sin)[:2]
    want = _layer_run(paddle_tpu, cfg, w, x, cos, sin)[:2]
    cases.assert_same(list(got), list(want), LAYER_TOL, "decoder layer")


def test_decoder_layer_matches_the_ports_llama_layer():
    from paddle_tpu_torch import LlamaForCausalLM

    cfg, w, x, cos, sin = _layer_inputs()
    out, g, gw = _layer_run(pt, cfg, w, x, cos, sin)
    model = LlamaForCausalLM(cfg, device="cpu")
    layer = model.model.layers[0]
    with torch.no_grad():
        for mod, key in ((layer.self_attn.q_proj, "wq"),
                         (layer.self_attn.k_proj, "wk"),
                         (layer.self_attn.v_proj, "wv"),
                         (layer.self_attn.o_proj, "wo"),
                         (layer.mlp.gate_proj, "wg"),
                         (layer.mlp.up_proj, "wu"),
                         (layer.mlp.down_proj, "wd"),
                         (layer.input_layernorm, "ln1"),
                         (layer.post_attention_layernorm, "ln2")):
            mod.weight.copy_(torch.from_numpy(w[key]))
    xt = torch.from_numpy(x).requires_grad_()
    cos_t, sin_t = model.model._tables(16, xt)
    ref = layer(xt, cos_t, sin_t)
    (ref_g,) = torch.autograd.grad((ref * torch.from_numpy(gw)).sum(), xt)
    cases.assert_same([out, g], [ref, ref_g], LAYER_TOL, "port layer")


# -- (g) places ----------------------------------------------------------------

def test_set_device_and_resolve_device(monkeypatch):
    assert pt.device.resolve_device() == torch.device("cpu")
    assert pt.device.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, dev in (("gpu", torch.device("cuda")),
                      ("gpu:1", torch.device("cuda", 1)),
                      ("cuda:0", torch.device("cuda", 0))):
        pt.set_device(name)
        assert pt.device.resolve_device() == dev
        assert pt.get_device() == f"gpu:{dev.index or 0}"
    assert pt.device.resolve_device("cpu") == torch.device("cpu")   # wins
    pt.set_device("cpu")
    assert pt.device.resolve_device("gpu:1") == torch.device("cuda", 1)
    with pytest.raises(ValueError):
        pt.device.resolve_device("meta")


def test_creation_without_cuda_follows_the_policy(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    place._current[0] = None                  # the default place: the card
    for make in (lambda: pt.zeros([2]), lambda: pt.to_tensor([1.0]),
                 lambda: pt.arange(3), lambda: pt.rand([2]),
                 pt.get_device):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    pt.set_device("cpu")
    assert pt.zeros([2]).device.type == "cpu"
    assert pt.randn([2]).device.type == "cpu"
    assert pt.get_device() == "cpu:0"

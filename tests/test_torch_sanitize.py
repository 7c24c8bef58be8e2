"""The sanitizers ``debug_nans`` and ``checked`` of the port against the
JAX package's (``jax_debug_nans`` and ``checkify``) on the CPU: each case of
``tests/test_sanitize.py`` (a NaN raised at its source op, the previous
state restored after the scope, ``checked`` through a loop) and the checks
``checked`` selects, ``nan``, ``div`` and ``oob``, on the same inputs. The
port raises, or does not, where the JAX package does, and names the op
(the JAX package names the primitive).

Two cases differ by design and are held on the port alone: an integer
remainder by zero, which ``checked(div=True)`` also refuses (torch on the
CPU raises for it anyway, and the card gives garbage), and the flag checks
of each op of a render (``debug_nans`` around a ``RenderPass`` render of a
clean scene raises nothing, of a scene with a NaN pose raises)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stillleben_tpu_torch as sl
import torch_port_scene  # noqa: F401  (one torch thread per xdist worker)
from stillleben_tpu.utils import sanitize as jsan
from stillleben_tpu_torch.utils import sanitize

# (name, function of (xp, *args), inputs as numpy)
NAN_SOURCES = [
    ("log of -1", lambda xp, a: xp.log(a), (np.float32([-1.0, 2.0]),)),
    ("sqrt of -1", lambda xp, a: xp.sqrt(a), (np.float32([4.0, -1.0]),)),
    ("0 / 0", lambda xp, a, b: a / b, (np.float32([0.0, 1.0]), np.float32([0.0, 2.0]))),
    ("inf - inf", lambda xp, a: (a * 1e38 * 1e38) - (a * 1e38 * 1e38), (np.float32([1.0]),)),
]
CLEAN = [
    ("log of 2", lambda xp, a: xp.log(a) + 1.0, (np.float32([2.0, 3.0]),)),
    ("1 / 0 is inf, not nan", lambda xp, a, b: a / b, (np.float32([1.0]), np.float32([0.0]))),
]


def _jax(fn, args):
    return fn(jnp, *map(jnp.asarray, args))


def _torch(fn, args):
    return fn(torch, *map(torch.from_numpy, args))


def _raises(call) -> str | None:
    """The error's text, or None when ``call`` returns."""
    try:
        out = call()
        jax.block_until_ready(out) if isinstance(out, jax.Array) else None
    except (FloatingPointError, ValueError, RuntimeError) as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", NAN_SOURCES + CLEAN, ids=lambda c: c[0])
def test_debug_nans_raises_where_jax_does(case):
    _, fn, args = case
    with jsan.debug_nans(True):
        jax_err = _raises(lambda: _jax(fn, args))
    with sanitize.debug_nans(True):
        port_err = _raises(lambda: _torch(fn, args))
    assert (jax_err is None) == (port_err is None), (jax_err, port_err)
    if port_err is not None:
        assert "nan" in port_err and "aten." in port_err
    # outside the scope neither raises
    assert _raises(lambda: _jax(fn, args)) is None and _raises(lambda: _torch(fn, args)) is None


def test_debug_nans_names_the_source_op():
    with pytest.raises(FloatingPointError, match=r"aten\.log"):
        with sanitize.debug_nans():
            torch.log(torch.tensor(-1.0)) + 0.0  # noqa: B018
    with pytest.raises(FloatingPointError, match=r"aten\.sqrt"):
        with sanitize.debug_nans():
            torch.sqrt(torch.tensor([-1.0, 4.0])).sum()


def test_debug_nans_context_restores():
    """``tests/test_sanitize.py::test_debug_nans_context_restores`` on the
    port: the scope raises inside, the previous state is back after it,
    nesting included (``debug_nans(False)`` turns an enclosing check off
    inside, the enclosing check applies again after)."""
    depth = torch._C._len_torch_dispatch_stack()
    prev = jax.config.jax_debug_nans
    with sanitize.debug_nans(True), jsan.debug_nans(True):
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0)) + 0.0  # noqa: B018
        with sanitize.debug_nans(False), jsan.debug_nans(False):
            assert torch.isnan(torch.log(torch.tensor(-1.0)))
            assert jnp.isnan(jnp.log(jnp.float32(-1.0)))
            with sanitize.debug_nans(True), pytest.raises(FloatingPointError):
                torch.log(torch.tensor(-1.0))
        assert jax.config.jax_debug_nans is True
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0))
    assert jax.config.jax_debug_nans is prev
    assert torch._C._len_torch_dispatch_stack() == depth
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
    with sanitize.debug_nans(False):  # with nothing to turn off: no mode at all
        assert torch._C._len_torch_dispatch_stack() == depth


def test_debug_nans_exception_restores():
    depth = torch._C._len_torch_dispatch_stack()
    with pytest.raises(KeyError):
        with sanitize.debug_nans():
            raise KeyError("x")
    assert torch._C._len_torch_dispatch_stack() == depth
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


def _scan_step(xp, x):
    """``tests/test_sanitize.py::test_checked_raises_inside_jit_scan``'s
    function: three steps of sqrt(c - 1), NaN once c < 1."""
    if xp is jnp:
        def body(c, _):
            return jnp.sqrt(c - 1.0), None

        return jax.lax.scan(body, x, None, length=3)[0]
    for _ in range(3):
        x = torch.sqrt(x - 1.0)
    return x


@pytest.mark.parametrize("x0,raises", [(1e6, False), (0.5, True)])
def test_checked_nan_through_a_loop(x0, raises):
    jf = jsan.checked(jax.jit(lambda x: _scan_step(jnp, x)))
    pf = sanitize.checked(lambda x: _scan_step(torch, x))
    jax_err = _raises(lambda: jf(jnp.float32(x0)))
    port_err = _raises(lambda: pf(torch.tensor(x0, dtype=torch.float32)))
    assert (jax_err is not None) == (port_err is not None) == raises, (jax_err, port_err)
    if not raises:
        np.testing.assert_allclose(float(pf(torch.tensor(x0, dtype=torch.float32))),
                                   float(jf(jnp.float32(x0))), rtol=1e-6)
    else:
        assert "nan" in jax_err and "nan" in port_err


DIV_CASES = [  # (name, fn, inputs, div flag)
    ("int floor division by 0", lambda a, b: a // b, (np.int32([0, 1, 2]), np.int32([1, 0, 1])), True),
    ("int floor division", lambda a, b: a // b, (np.int32([0, 1, 2]), np.int32([1, 3, 1])), True),
    ("int true division by 0", lambda a, b: a / b, (np.int32([0, 1, 2]), np.int32([1, 0, 1])), True),
    ("float division by 0", lambda a, b: a / b, (np.float32([0, 1, 2]), np.float32([1, 0, 1])), True),
    ("float division by a scalar 0", lambda a, b: a / 0, (np.float32([1, 2]), np.float32([1, 1])), True),
    ("float floor division by 0", lambda a, b: a // b, (np.float32([3, 1]), np.float32([0, 1])), True),
    ("float division", lambda a, b: a / b, (np.float32([1, 2]), np.float32([4, 8])), True),
    ("float division by 0, div off", lambda a, b: a / b, (np.float32([0, 1, 2]), np.float32([1, 0, 1])), False),
]


@pytest.mark.parametrize("case", DIV_CASES, ids=lambda c: c[0])
def test_checked_div_where_jax_does(case):
    _, fn, args, div = case
    jax_err = _raises(lambda: jsan.checked(fn, div=div)(*map(jnp.asarray, args)))
    port_err = _raises(lambda: sanitize.checked(fn, div=div)(*map(torch.from_numpy, args)))
    assert (jax_err is None) == (port_err is None), (jax_err, port_err)
    if port_err is not None and "division" in jax_err:
        assert "division by zero" in port_err


def test_checked_div_refuses_remainder_by_zero():
    """The port's ``div`` check also refuses a remainder by zero, before the
    op: on the card an integer remainder by zero gives garbage."""
    x, y = torch.tensor([4, 5]), torch.tensor([2, 0])
    for fn in (lambda a, b: a % b, torch.fmod, lambda a, b: torch.remainder(a, 0)):
        with pytest.raises(sanitize.CheckError, match="division by zero"):
            sanitize.checked(fn)(x, y)
    assert sanitize.checked(lambda a, b: a % b)(x, torch.tensor([2, 3])).tolist() == [0, 2]


OOB_CASES = [  # (name, jax fn, torch fn, array, index)
    ("in range", lambda a, i: a[i], None, np.arange(3), np.int32([2, 0])),
    ("negative in range", lambda a, i: a[i], None, np.arange(3), np.int32([-1, -3])),
    ("past the end", lambda a, i: a[i], None, np.arange(3), np.int32([0, 3])),
    ("negative past the start", lambda a, i: a[i], None, np.arange(3), np.int32([-4])),
    ("second axis", lambda a, i: a[:, i], None, np.ones((2, 3), np.float32), np.int32([1, 3])),
    ("mask and index", lambda a, i: a[np.array([True, False]), i], None,
     np.ones((2, 3), np.float32), np.int32([2])),
    ("take_along_axis / gather", lambda a, i: jnp.take_along_axis(a, i, axis=0),
     lambda a, i: torch.gather(a, 0, i), np.arange(3), np.int64([0, 5])),
    ("gather in range", lambda a, i: jnp.take_along_axis(a, i, axis=0),
     lambda a, i: torch.gather(a, 0, i), np.arange(3), np.int64([2, 1])),
    ("scatter", lambda a, i: a.at[i].set(7), lambda a, i: a.index_put((i,), torch.tensor(7)),
     np.arange(3), np.int64([0, 5])),
    ("index_select / take", lambda a, i: jnp.take(a, i, axis=0, mode="promise_in_bounds"),
     lambda a, i: a.index_select(0, i), np.arange(4), np.int64([1, 4])),
]


@pytest.mark.parametrize("case", OOB_CASES, ids=lambda c: c[0])
def test_checked_oob_where_jax_does(case):
    _, jfn, tfn, a, i = case
    tfn = tfn or jfn
    jax_err = _raises(lambda: jsan.checked(jfn, oob=True)(jnp.asarray(a), jnp.asarray(i)))
    port_err = _raises(lambda: sanitize.checked(tfn, oob=True)(torch.from_numpy(a),
                                                               torch.from_numpy(i).long()))
    assert (jax_err is None) == (port_err is None), (jax_err, port_err)
    if port_err is not None:
        assert "out-of-bounds indexing" in port_err and "out of bounds for" in port_err
    else:
        out = sanitize.checked(tfn, oob=True)(torch.from_numpy(a), torch.from_numpy(i).long())
        np.testing.assert_array_equal(out.numpy(), np.asarray(jfn(jnp.asarray(a), jnp.asarray(i))))


def test_checked_oob_off_and_ops_of_the_port():
    """Without ``oob`` nothing is checked before the op (the CPU op raises
    its own error); the other indexing ops the check knows."""
    a = torch.arange(6.0).reshape(2, 3)
    with pytest.raises(IndexError):
        sanitize.checked(lambda x: x[:, torch.tensor([3])])(a)
    bad = torch.tensor([[0, 3]])
    for fn in (lambda x: x.scatter(1, bad, 1.0), lambda x: x.index_add(1, torch.tensor([3]), x[:, :1]),
               lambda x: torch.take(x, torch.tensor([6])),
               lambda x: torch.nn.functional.embedding(torch.tensor([2]), x)):
        with pytest.raises(sanitize.CheckError, match="out-of-bounds"):
            sanitize.checked(fn, oob=True)(a)
    assert sanitize.checked(lambda x: torch.take(x, torch.tensor([-6, 5])), oob=True)(a).tolist() == [0, 5]


def test_checked_returns_and_names():
    def f(x):
        return x * 2

    g = sanitize.checked(f, oob=True)
    assert g.__name__ == "f" and torch.equal(g(torch.ones(2)), 2 * torch.ones(2))
    assert torch._C._len_torch_dispatch_stack() == 0


def _scene(pose):
    scene = sl.Scene((48, 32))
    obj = sl.Object(sl.Mesh("primitive://cube", physics=False))
    obj.set_pose(pose)
    scene.add_object(obj)
    scene.set_camera_look_at([3.0, 2.0, 3.0], [0.0, 0.0, 0.0])
    return scene


def test_debug_nans_around_a_render():
    """A clean scene renders under the mode with the frame unchanged; a
    NaN pose raises at the first op that outputs a NaN, naming it."""
    sl.init(device="cpu")
    rp = sl.RenderPass(ssao=False)
    scene = _scene(np.eye(4, dtype=np.float32))
    ref = rp.render(scene).rgb()
    with sanitize.debug_nans():
        assert torch.equal(rp.render(scene).rgb(), ref)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = np.nan
    scene.objects[0].set_pose(T)
    with pytest.raises(FloatingPointError, match=r"invalid value \(nan\) encountered in aten\."):
        with sanitize.debug_nans():
            rp.render(scene)

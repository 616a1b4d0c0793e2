"""Helpers of the port's parity tests: one numpy input, made from a seed,
handed to both the reference package (JAX) and the port (PyTorch)."""
import jax.numpy as jnp
import numpy as np
import torch

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def randn(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def both(a, dtype="float32"):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return (jnp.asarray(a, JDT[dtype]),
                torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dtype]))
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def to_np(x):
    """JAX array or tensor -> float32 (or integer) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "f" or \
        x.dtype.name == "bfloat16" else x


def assert_close(got, want, dtype="float32", tol=None):
    tol = TOL[dtype] if tol is None else tol
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


def close_logits(got, want, tol=1e-4):
    """Whole-model logits within ``tol`` of the largest logit, and the
    same greedy tokens."""
    scale = max(float(np.abs(to_np(want)).max()), 1.0)
    assert_close(got, want, tol=tol * scale)
    np.testing.assert_array_equal(to_np(got).argmax(-1),
                                  to_np(want).argmax(-1))


def flat_tree(tree, prefix=""):
    """{dotted path: leaf} of a nested dict/list pytree (the reference's
    parameters), in the names ``state_dict()`` gives a ParamTree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for name, t in items:
        out.update(flat_tree(t, f"{prefix}.{name}" if prefix else name))
    return out


def assert_converted_exactly(pt, pj):
    """Every leaf of the reference's tree arrived bit for bit."""
    want = flat_tree(pj)
    got = pt.state_dict()
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        a = np.asarray(leaf)
        t = got[name]
        assert tuple(t.shape) == a.shape, name
        np.testing.assert_array_equal(to_np(t), to_np(a), err_msg=name)

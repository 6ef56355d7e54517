"""The port's completeness guard: every public name of the JAX package
resolves in the matching module of the port, or is listed in
``NOT_PORTED`` with its reason.

One case per ``genjax_tpu`` module that has an ``__all__`` (each name of
it), and one case per public module-level ``def`` or ``class`` of every
``genjax_tpu`` module, found by reading the source. The port module of
``genjax_tpu.a.b`` is ``genjax_torch.a.b``. A name that the JAX package
adds later fails here until the port has it or ``NOT_PORTED`` says why
it does not. The rest of the file holds the names this guard first
found missing against the JAX functions on the CPU.
"""

import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_torch as gt
import genjax_tpu as gj

JAX_ROOT = pathlib.Path(gj.__file__).parent

_JAXPR = ("jaxpr machinery: the port runs plain Python under a handler "
          "stack (ROADMAP 'Not to port', ARCHITECTURE.md §1)")
_PALLAS = ("Pallas internals of a TPU kernel: the port's kernel is CUDA C++ "
           "behind its wrapper in the same module (ROADMAP §2)")
_JAX_TYPE = ("a JAX sharding type: the port's meshes are torch "
             "DeviceMeshes over the initialized world (parallel/mesh.py)")

#: Name (bare) or module (dotted) -> why the port has no counterpart.
NOT_PORTED = {
    "stage": _JAXPR + "; `@gen` bodies are not staged to a jaxpr",
    "get_shaped_aval": _JAXPR + "; a torch tensor is always concrete",
    "incremental": _JAXPR + "; the port's Diff handler is "
                   "`lang/static_edit.py`'s change tracker",
    "IncrementalHandler": _JAXPR + "; see `incremental`",
    "eval_jaxpr_incremental": _JAXPR + "; see `incremental`",
    "edit_via_incremental": _JAXPR + "; the fine edit path is "
                            "`lang/static_edit.py`",
    "StagingHandler": _JAXPR + "; the fine edit path records sites "
                      "while the body runs",
    "site_p": _JAXPR + "; no primitive marks a site in plain Python",
    "sample_p": _JAXPR + "; ADEV sites are `adev.core.sample_primitive` "
                "calls under a handler",
    "invoke_closed_over": _JAXPR + "; the ADEV CPS interpreter's "
                          "closure primitive",
    "invoke_closed_over_jvp": _JAXPR + "; its JVP rule",
    "genjax_tpu.core.compiler.initial_style_primitive":
        _JAXPR + "; the jaxpr side of `@gen`",
    "genjax_tpu.core.compiler.interpreters.stateful":
        _JAXPR + "; the port's handler stack replaces it",
    "genjax_tpu.core.compiler.interpreters.environment":
        _JAXPR + "; the stateful interpreter's variable environment",
    "genjax_tpu.core.compiler.taint":
        "TPU workaround: the port's invariant leaves are the zero-stride "
        "ones (`inference/smc.py::invariant_leaf_mask`)",
    "Mesh": _JAX_TYPE,
    "NamedSharding": _JAX_TYPE,
    "P": _JAX_TYPE,
    "log_matmul_jnp": _PALLAS + "; the plain version is "
                      "`ops.logmatmul.log_matmul_plain`",
    "log_matmul_pallas": _PALLAS + "; the kernel is `csrc/logmatmul.cu` "
                         "behind `ops.logmatmul.log_matmul`",
    "mxu_dot": "TPU workaround: bf16 MXU contraction; the port uses a "
               "torch matmul, TF32 decided per path",
    "systematic_cumulative_pallas": _PALLAS + "; the kernel is "
                                    "`csrc/cdf_counts.cu` behind "
                                    "`ops.cdf_counts.systematic_cumulative`",
    "pick_chunk_rows": _PALLAS + "; the TPU kernel's grid chunking",
    "supports_pallas_cdf": _PALLAS + "; the TPU kernel's shape gate",
    "make_fused_step": _PALLAS + "; the kernel is `csrc/fused_step.cu` "
                       "behind `ops.fused_step.fused_step`",
    "fused_step_reference": _PALLAS + "; the plain version is "
                            "`ops.fused_step.fused_step_plain`",
    "supports_fused_step": _PALLAS + "; the TPU kernel's shape gate",
    "genjax_tpu.ops.mxu": "TPU workaround: bf16 MXU contraction "
                          "(see `mxu_dot`)",
    "genjax_tpu.ops.onehot": "TPU workaround: one-hot MXU contractions; "
                             "the port indexes",
    "genjax_tpu.ops.resample": "TPU workaround: blocked interval "
                               "expansion; the port gathers by ancestor "
                               "index",
}


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(JAX_ROOT.parent).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _jax_modules():
    return sorted(_module_name(p) for p in JAX_ROOT.rglob("*.py"))


def _public_defs(mod: str) -> list:
    path = JAX_ROOT.parent / (mod.replace(".", "/"))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    tree = ast.parse(path.read_text())
    return sorted(node.name for node in tree.body
                  if isinstance(node, (ast.FunctionDef, ast.ClassDef))
                  and not node.name.startswith("_"))


def _has_all(mod: str) -> bool:
    path = JAX_ROOT.parent / (mod.replace(".", "/"))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    return any(isinstance(n, ast.Assign) and any(
        isinstance(t, ast.Name) and t.id == "__all__" for t in n.targets)
        for n in ast.parse(path.read_text()).body)


MODULES = _jax_modules()
ALL_CASES = [m for m in MODULES if _has_all(m)]
DEF_CASES = [(m, n) for m in MODULES for n in _public_defs(m)]


def _port_module(mod: str):
    return importlib.import_module(
        mod.replace("genjax_tpu", "genjax_torch", 1))


def _missing(mod: str, names) -> list:
    if mod in NOT_PORTED:
        return []
    port = _port_module(mod)
    return [n for n in names if not hasattr(port, n) and n not in NOT_PORTED]


@pytest.mark.parametrize("mod", ALL_CASES)
def test_all_names_resolve(mod):
    """Every name of the JAX module's ``__all__`` is an attribute of the
    port module, or in ``NOT_PORTED``."""
    names = importlib.import_module(mod).__all__
    assert _missing(mod, names) == []


@pytest.mark.parametrize("mod,name", DEF_CASES,
                         ids=[f"{m}:{n}" for m, n in DEF_CASES])
def test_public_def_resolves(mod, name):
    """A public module-level def or class of the JAX module exists in the
    port module, or is in ``NOT_PORTED``."""
    assert _missing(mod, [name]) == []


def test_not_ported_has_no_stale_entry():
    """Each ``NOT_PORTED`` entry names a JAX module, or a public name of
    one that the port really lacks somewhere: a name ported later must
    leave the dict."""
    for key in NOT_PORTED:
        if key.startswith("genjax_tpu."):
            assert key in MODULES, key
            with pytest.raises(ModuleNotFoundError):
                _port_module(key)
            continue
        homes = [m for m in MODULES if m not in NOT_PORTED and (
            key in _public_defs(m)
            or (_has_all(m) and key in importlib.import_module(m).__all__))]
        assert homes, key
        assert any(not hasattr(_port_module(m), key) for m in homes), key


def test_user_surface_names_work():
    """The names the guard first found missing, used as a user would."""
    key = gt.random.key(0, device="cpu")

    @gt.gen
    def std():
        return gt.normal(0.0, 1.0) @ "z"

    scaled = gt.dimap(pre=lambda *a: a, post=lambda a, r: 3.0 + 0.5 * r)(std)
    tr = scaled.simulate(key, ())
    assert torch.allclose(tr.get_retval(), 3.0 + 0.5 * tr.get_choices()["z"])
    masked = gt.mask(std)
    assert float(masked.simulate(key, (False,)).get_score()) == 0.0
    assert float(masked.simulate(key, (True,)).get_score()) != 0.0
    x = torch.randn(3, 4, 5, generator=torch.Generator().manual_seed(1))
    y = torch.randn(3, 5, 2, generator=torch.Generator().manual_seed(2))
    want = torch.logsumexp(x[..., :, :, None] + y[..., None, :, :], dim=-2)
    assert torch.allclose(gt.ops.log_matmul(x, y), want, atol=1e-5)
    for name in ("Dimap", "DimapTrace", "contramap", "map_retval",
                 "MaskCombinator", "MaskTrace", "ScanTrace", "SwitchTrace",
                 "VmapTrace", "masked_iterate", "masked_iterate_final",
                 "prepend_initial_acc"):
        assert getattr(gt, name) is getattr(gt.lang.combinators, name)
    assert gt.lang.StaticRequest is gt.StaticRequest
    from genjax_torch.inference import exact_testbed

    assert (gt.inference.DiscreteHMMInferenceProblem
            is exact_testbed.DiscreteHMMInferenceProblem)
    assert (gt.inference.build_test_against_exact_inference
            is exact_testbed.build_test_against_exact_inference)


def test_particle_filter_class_matches_function():
    """``ParticleFilter`` runs :func:`particle_filter` bit for bit, by
    ``run`` and by call, and keeps ``n_particles``; the JAX class gives
    the same log Z within the filters' shared f32 path."""
    from genjax_torch.core import random as R
    from genjax_torch.inference import ParticleFilter, particle_filter
    from genjax_tpu.inference import ParticleFilter as JaxParticleFilter

    def init(keys):
        return R.normal(keys), torch.zeros(())

    def step(keys, x, y):
        x = 0.9 * x + 0.3 * R.normal(keys)
        return x, (-0.5 * ((y - x) / 0.5) ** 2
                   - np.log(0.5 * np.sqrt(2 * np.pi)))

    ys = torch.tensor([0.1, -0.2, 0.3, 0.0, 0.4])
    key = R.key(0, device="cpu")
    pf = ParticleFilter(init, step, 512)
    assert pf.n_particles == 512
    want, _ = particle_filter(init, step, 512)(key, ys)
    for got, _ in (pf.run(key, ys), pf(key, ys)):
        assert torch.equal(got.log_z, want.log_z)
        assert torch.equal(got.particles, want.particles)

    jpf = JaxParticleFilter(
        lambda k: (jax.random.normal(k), jnp.zeros(())),
        lambda k, x, y: ((xn := 0.9 * x + 0.3 * jax.random.normal(k)),
                         jax.scipy.stats.norm.logpdf(y, xn, 0.5)), 512)
    assert jpf.n_particles == 512
    jfinal, _ = jax.jit(jpf)(jax.random.key(0), jnp.asarray(ys.numpy()))
    assert abs(float(jfinal.log_z) - float(want.log_z)) < 1e-4


def test_nth_matches_jax():
    from genjax_torch.core.pytree import nth
    from genjax_tpu.core.pytree import nth as jax_nth

    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": (rng.normal(size=(4,)).astype(np.float32),)}
    got = nth({"a": torch.tensor(tree["a"]),
               "b": (torch.tensor(tree["b"][0]),)}, 2)
    want = jax_nth(jax.tree_util.tree_map(jnp.asarray, tree), 2)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0].numpy(),
                                  np.asarray(want["b"][0]))


@pytest.mark.parametrize("value", [1, 2.5, True, np.float32(1.0),
                                   np.arange(3), np.ones(2, np.float64)])
def test_typing_helpers_match_jax(value):
    from genjax_torch.core.typing import static_check_supports_grad, to_float
    from genjax_tpu.core import typing as jt

    port_value = value
    if isinstance(value, np.ndarray):
        port_value = torch.as_tensor(value)
    assert (static_check_supports_grad(port_value)
            == bool(jt.static_check_supports_grad(value)))
    got, want = to_float(port_value), jt.to_float(value)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_welford_update_batch_matches_jax():
    from genjax_torch.inference import adaptation as ta
    from genjax_tpu.inference import adaptation as ja

    rng = np.random.default_rng(3)
    a = rng.normal(size=(16, 3)).astype(np.float32)
    b = rng.normal(size=(8, 3)).astype(np.float32) + 1.0
    js, ts = ja.welford_init(3), ta.welford_init(3)
    for zs in (a, b):
        js = ja.welford_update_batch(js, jnp.asarray(zs))
        ts = ta.welford_update_batch(ts, torch.tensor(zs))
    for got, want in zip(ts, js):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ta.welford_variance(ts).numpy(),
                               np.asarray(ja.welford_variance(js)),
                               rtol=1e-6)


def test_lanes_leading_matches_jax():
    """A Vmap trace's choices stacked over 5 executions by hand (the
    layout ``jax.vmap`` returns): after ``lanes_leading`` both packages
    read lane 2 as the batch of its 5 values, and every leaf has the same
    layout. Varying explicit addresses raise in both."""
    from genjax_torch.gfi.choice_map import Indexed as TIndexed
    from genjax_torch.gfi.choice_map import lanes_leading
    from genjax_tpu.gfi.choice_map import Indexed as JIndexed
    from genjax_tpu.gfi.choice_map import lanes_leading as jax_lanes_leading

    vals = np.arange(5 * 4, dtype=np.float32).reshape(5, 4)
    jchm = JIndexed(gj.C["z"].set(jnp.asarray(vals)), None)
    tchm = TIndexed(gt.C["z"].set(torch.tensor(vals)), None)
    jout = jax_lanes_leading(jchm, 1)
    tout = lanes_leading(tchm, 1)
    np.testing.assert_array_equal(tout[2, "z"].numpy(),
                                  np.asarray(jout[2, "z"]))
    np.testing.assert_array_equal(tout[:, "z"].numpy(),
                                  np.asarray(jout[:, "z"]))
    assert tuple(tout[:, "z"].shape) == (4, 5)

    idx = np.array([[0, 1], [1, 0]])
    with pytest.raises(ValueError):
        jax_lanes_leading(JIndexed(gj.C["z"].set(jnp.zeros((2, 2))),
                                   jnp.asarray(idx)), 1)
    with pytest.raises(ValueError):
        lanes_leading(TIndexed(gt.C["z"].set(torch.zeros(2, 2)),
                               torch.tensor(idx)), 1)
    same = np.array([[3, 7], [3, 7]])
    jo = jax_lanes_leading(JIndexed(gj.C["z"].set(jnp.asarray(vals[:2, :2])),
                                    jnp.asarray(same)), 1)
    to = lanes_leading(TIndexed(gt.C["z"].set(torch.tensor(vals[:2, :2])),
                                torch.tensor(same)), 1)
    np.testing.assert_array_equal(to[7, "z"].numpy(), np.asarray(jo[7, "z"]))


def test_jtu_select_and_threefry_reexport():
    from genjax_torch.core import random as R
    from genjax_torch.inference.requests.nuts import jtu_select
    from genjax_torch.ops import fused_step

    pred = torch.tensor([True, False])
    a = {"x": torch.ones(2, 3)}
    b = {"x": torch.zeros(2, 3)}
    out = jtu_select(pred, a, b)
    assert torch.equal(out["x"], torch.tensor([[1.0] * 3, [0.0] * 3]))
    assert fused_step.threefry2x32 is R.threefry2x32


def _programs():
    from genjax_torch.examples import COOKBOOK, EXAMPLES

    return list(EXAMPLES) + list(COOKBOOK)


@pytest.mark.parametrize("name", _programs())
def test_program_defaults_to_the_card(name, monkeypatch):
    """Every ported documented program runs on the card by default and
    raises where there is none, before any work; nothing falls back to
    the CPU."""
    from genjax_torch.examples import module_name

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(module_name(name))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main()


def test_documented_programs_cover_the_docs():
    """One port program for each JAX program of docs/examples and
    docs/cookbook, by number and name (cookbook 9's TPU page becomes
    the H100 page)."""
    from genjax_torch.examples import COOKBOOK, EXAMPLES

    docs = JAX_ROOT.parent / "docs"
    ex = sorted(p.stem for p in (docs / "examples").glob("*.py"))
    cb = sorted(p.stem for p in (docs / "cookbook").glob("*.py"))
    assert [f"ex{s}" for s in ex] == list(EXAMPLES)
    assert [f"cb{s}".replace("tpu_performance", "h100_performance")
            for s in cb] == list(COOKBOOK)


def test_programs_import_no_jax():
    """The port's programs import torch and never jax or genjax_tpu."""
    import subprocess
    import sys

    code = ("import sys, importlib\n"
            "from genjax_torch.examples import EXAMPLES, COOKBOOK, "
            "module_name\n"
            "for n in EXAMPLES + COOKBOOK:\n"
            "    importlib.import_module(module_name(n))\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'genjax_tpu'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=JAX_ROOT.parent)

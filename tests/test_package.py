"""Package plumbing: the pytree dataclass helper, the compile-cache
location, and the GPU-only entry points refusing to run elsewhere."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

import tpu_pt
from tpu_pt import pytree

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytree.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray = None
    tag: str = pytree.static_field(default="x")


def test_pytree_replace_and_frozen():
    p = _Pair(a=jnp.ones(2))
    q = p.replace(tag="y", b=jnp.zeros(2))
    assert p.tag == "x" and p.b is None
    assert q.tag == "y" and q.b.shape == (2,)
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.tag = "z"


def test_pytree_flatten_round_trip():
    p = _Pair(a=jnp.arange(3.0), b=jnp.ones(1), tag="t")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2              # the static field is no leaf
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.tag == "t"
    assert (back.a == p.a).all() and (back.b == p.b).all()
    # None children flatten to nothing, as in any pytree.
    assert len(jax.tree_util.tree_leaves(_Pair(a=jnp.ones(1)))) == 1


def test_pytree_static_fields_under_jit():
    """Static fields stay Python values under jit: a new array value
    reuses the executable, a new static value compiles another."""
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.tag)
        assert isinstance(p.tag, str)
        return p.a * 2.0

    f(_Pair(a=jnp.ones(3), tag="s"))
    f(_Pair(a=jnp.zeros(3), tag="s"))
    assert traces == ["s"]
    f(_Pair(a=jnp.zeros(3), tag="u"))
    assert traces == ["s", "u"]


def test_scene_arrays_static_fields_survive_tree_map(mixed_scene):
    moved = jax.tree.map(lambda x: x, mixed_scene)
    assert moved.num_tris == mixed_scene.num_tris == 428
    assert moved.num_occluders == mixed_scene.num_occluders


@pytest.mark.parametrize("env,want", [
    (None, str(REPO / ".jax_cache")),
    ("/some/where", None),
], ids=["default", "env"])
def test_compile_cache_dir(monkeypatch, env, want):
    """``JAX_COMPILATION_CACHE_DIR`` wins (the package then sets no
    directory); otherwise the cache lives at a fixed path in the
    checkout."""
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert tpu_pt.compile_cache_dir() == want


def _run_cpu(args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, *args], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [
    ["chip_smoke.py"], ["bench.py"], ["-m", "tpu_pt.cli", "bench"],
    ["-m", "tpu_pt.cli", "bench", "assets/cornell_box.obj", "--spp", "2"],
], ids=["chip_smoke", "bench", "cli_bench", "cli_bench_flags"])
def test_gpu_entry_points_refuse_cpu(args):
    """Without a GPU the on-card check and the benchmark (directly or
    through the CLI) exit nonzero and print no result line."""
    r = _run_cpu(args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "Mrays" not in r.stdout
    assert "GPU" in r.stderr and "unrecognized" not in r.stderr


@pytest.mark.parametrize("flags,want", [
    ([], ["--scheduler", "pixelq", "--intersector", "auto"]),
    (["s.obj", "--width", "256", "--spp", "4", "--depth", "8",
      "--frames", "2", "--scheduler", "regen", "--intersector", "bvh"],
     ["--scheduler", "regen", "--intersector", "bvh",
      "--scene", os.path.abspath("s.obj"), "--size", "256", "--spp", "4",
      "--depth", "8", "--frames", "2"]),
], ids=["defaults", "all_flags"])
def test_cli_bench_argv(flags, want):
    """``tpu-pt bench`` hands bench.py only the flags changed from the
    CLI's defaults, under bench.py's own names."""
    from tpu_pt import cli
    ap = cli.argparse.ArgumentParser()
    cli._add_render_args(ap)
    assert cli.bench_argv(ap.parse_args(flags)) == want

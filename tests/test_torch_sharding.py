"""Port vs reference: mesh views, parameter specs, input specs, contexts.

The spec tables run in this process with no process group: both sides
compose their own ``sanitize_spec(param_spec(...))`` and ``_fsdp_spec``
over abstract leaves (the reference's ``eval_shape``, the port's ``meta``
tensors) on a stub view whose ``shape`` maps the view's axis names to
sizes, since the reference's ``NamedSharding`` needs a real mesh.  The
contexts and input shardings need real meshes of 8: the reference's side
runs in a subprocess with 8 host devices (as ``tests/test_distributed.py``
does), the port's in a subprocess on torch's fake process group.
"""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402
from repro_torch.train.tree import flatten  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCHS = tcfg.list_configs()
# mesh shapes (…, data, model) of the views compared
MESHES = [(16, 16), (2, 16, 16), (2, 4), (2, 2), (1, 4), (1, 2)]


def _reference_fsdp_spec():
    """The reference's ``_fsdp_spec``: ``repro.launch.dryrun`` sets
    ``XLA_FLAGS`` for 512 host devices when imported, which this process
    must not keep (other tests' jax runs in it)."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch.dryrun import _fsdp_spec
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return _fsdp_spec


def _view(cfg_t, mesh_shape):
    """A stub view of ``mesh_shape`` with the model axis split by the
    port's ``choose_view_factors``; the reference's agrees (tested)."""
    a, b = TS.choose_view_factors(cfg_t, mesh_shape[-1])
    names = ("pod", "data") if len(mesh_shape) == 3 else ("data",)
    return SimpleNamespace(shape=dict(zip(names + ("a", "b"),
                                          (*mesh_shape[:-1], a, b))))


_ABSTRACT = {}


def _abstract(arch):
    if arch not in _ABSTRACT:
        jc = jcfg.get_config(arch)
        ref = JS.abstract_params(jc)
        _ABSTRACT[arch] = (ref, TS.abstract_params(tcfg.get_config(arch)))
    return _ABSTRACT[arch]


@pytest.mark.parametrize("model_axis", [1, 2, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_view_factors_match_reference(arch, model_axis):
    assert TS.choose_view_factors(tcfg.get_config(arch), model_axis) == \
        JS.choose_view_factors(jcfg.get_config(arch), model_axis)


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp-only"])
@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_table_matches_reference(arch, mesh_shape, fsdp):
    """Every leaf's spec from the port's ``sharded_param_specs`` at full
    width equals the reference's, path for path."""
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    view = _view(tc, mesh_shape)
    ref_abs, port_abs = _abstract(arch)
    fsdp_spec = _reference_fsdp_spec()

    def ref_one(path, leaf):
        spec = JS.sanitize_spec(JS.param_spec(path, leaf, jc), leaf, view)
        if fsdp:
            stacked = bool(JS._STACKED.search(JS._path_str(path)))
            spec = fsdp_spec(spec, leaf, view, stacked)
        return tuple(spec)

    ref = {JS._path_str(path): ref_one(path, leaf) for path, leaf in
           jax.tree_util.tree_flatten_with_path(ref_abs)[0]}
    port = {path: tuple(s.spec) for path, s in flatten(
        TD.sharded_param_specs(port_abs, tc, view, fsdp=fsdp))}
    assert port == ref
    # the shapes behind the specs are the reference's
    assert {p: tuple(t.shape) for p, t in flatten(port_abs)} == {
        JS._path_str(p): tuple(x.shape) for p, x in
        jax.tree_util.tree_flatten_with_path(ref_abs)[0]}


def test_spec_table_keeps_the_reference_special_cases():
    """Qwen's 40 heads keep the 8-way "a" factor of a 16-way model axis;
    whisper's vocab of 51865 is replicated."""
    qwen = tcfg.get_config("qwen1.5-32b")
    assert TS.choose_view_factors(qwen, 16) == (8, 2)
    specs = dict(flatten(TD.sharded_param_specs(
        TS.abstract_params(qwen), qwen, _view(qwen, (16, 16)))))
    assert tuple(specs["layers/attn/wq"].spec) == (None, "data", ("a", "b"))
    whisper = tcfg.get_config("whisper-base")
    specs = dict(flatten(TD.sharded_param_specs(
        TS.abstract_params(whisper), whisper, _view(whisper, (16, 16)))))
    assert tuple(specs["embed"].spec)[0] is None
    assert tuple(specs["lm_head"].spec)[1] is None


@pytest.mark.parametrize("shape_name", list(tcfg.SHAPES))
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi-3-vision-4.2b",
                                  "whisper-base"],
                         ids=["no-frontend", "patch", "frames"])
def test_input_specs_match_reference(arch, shape_name):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    ref = JS.input_specs(jc, jcfg.SHAPES[shape_name])
    port = TS.input_specs(tc, tcfg.SHAPES[shape_name])
    assert list(port) == list(ref)
    for name, sds in ref.items():
        assert tuple(port[name].shape) == tuple(sds.shape)
        assert str(port[name].dtype).split(".")[-1] == str(sds.dtype)
        assert port[name].device.type == "meta"


# ---------------------------------------------------------------------------
# contexts and input shardings on real meshes of 8
# ---------------------------------------------------------------------------

CTX_MESHES = [((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
              ((2, 2, 2), ("pod", "data", "model"))]
RUNS = [{}, {"remat": "none", "sequence_parallel": False, "ssm_chunk": 64}]
FRONTEND_ARCHS = ["tinyllama-1.1b", "phi-3-vision-4.2b", "whisper-base"]

_BODY = """
import json
out = {"ctx": {}, "inputs": {}}
for shape, axes in MESHES:
    mesh = make_mesh(shape, axes)
    for arch in list_configs():
        for i, run in enumerate(RUNS):
            cfg = get_config(arch)
            ctx = make_context(mesh, cfg, RunConfig(**run))
            key = f"{arch}|{'x'.join(map(str, shape))}|{i}"
            out["ctx"][key] = {
                "axes": {k: list(v) if isinstance(v, tuple) else v
                         for k, v in ctx.axes.items()},
                "ep_axis": ctx.ep_axis, "ep_tp_axis": ctx.ep_tp_axis,
                "remat": ctx.remat, "sp": ctx.sequence_parallel,
                "ssm_chunk": ctx.ssm_chunk,
                "names": list(view_names(ctx.mesh)),
                "sizes": list(view_sizes(ctx.mesh))}
        for arch in FRONTEND_ARCHS:
            cfg = get_config(arch)
            view = make_context(mesh, cfg, RunConfig()).mesh
            for sname, shp in SHAPES.items():
                key = f"{arch}|{'x'.join(map(str, shape))}|{sname}"
                out["inputs"][key] = {
                    n: [list(e) if isinstance(e, tuple) else e
                        for e in spec_of(s)]
                    for n, s in input_shardings(cfg, shp, view).items()}
print("JSON" + json.dumps(out))
"""

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
from repro.configs import SHAPES, get_config, list_configs
from repro.configs.base import RunConfig
from repro.parallel.sharding import input_shardings, make_context

def make_mesh(shape, axes):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                             axes)

def view_names(v):
    return v.axis_names

def view_sizes(v):
    return v.devices.shape

def spec_of(s):
    return tuple(s.spec)
"""

_PORT = """
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
from repro_torch.configs import RunConfig, SHAPES, get_config, list_configs
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.parallel.sharding import input_shardings, make_context

def make_mesh(shape, axes):
    return make_smoke_mesh(shape, axes, device="cpu")

def view_names(v):
    return v.mesh_dim_names

def view_sizes(v):
    return tuple(v.mesh.shape)

def spec_of(s):
    return tuple(s.spec)
"""


def _run(prelude: str) -> dict:
    head = (f"MESHES = {CTX_MESHES!r}\nRUNS = {RUNS!r}\n"
            f"FRONTEND_ARCHS = {FRONTEND_ARCHS!r}\n")
    code = textwrap.dedent(prelude) + head + textwrap.dedent(_BODY)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu",
                            "PYTHONPATH": os.path.join(ROOT, "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("JSON")][-1]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def both_sides():
    return _run(_REFERENCE), _run(_PORT)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_context_matches_reference(both_sides, arch):
    ref, port = both_sides
    keys = [k for k in ref["ctx"] if k.startswith(arch + "|")]
    assert keys and sorted(keys) == sorted(
        k for k in port["ctx"] if k.startswith(arch + "|"))
    for k in keys:
        assert port["ctx"][k] == ref["ctx"][k], k


@pytest.mark.parametrize("arch", FRONTEND_ARCHS,
                         ids=["no-frontend", "patch", "frames"])
def test_input_shardings_match_reference(both_sides, arch):
    ref, port = both_sides
    keys = [k for k in ref["inputs"] if k.startswith(arch + "|")]
    assert len(keys) == len(CTX_MESHES) * len(tcfg.SHAPES)
    for k in keys:
        assert port["inputs"][k] == ref["inputs"][k], k


def test_input_shardings_on_a_stub_view_match_reference():
    """The same without a mesh: the port's ``input_shardings`` reads only
    the view's axis sizes."""
    view = SimpleNamespace(shape={"pod": 2, "data": 16, "a": 16, "b": 1})
    for arch in FRONTEND_ARCHS:
        tc = tcfg.get_config(arch)
        for sname, shp in tcfg.SHAPES.items():
            got = {n: tuple(s.spec) for n, s in
                   TS.input_shardings(tc, shp, view).items()}
            b = shp.global_batch
            rows = ("pod", "data") if b % 32 == 0 else None
            want = {"tokens": (rows, None)}
            if shp.mode == "train":
                want["labels"] = (rows, None)
            if shp.mode in ("train", "prefill") and tc.frontend:
                want[{"patch": "patch_embeds", "frames": "frame_embeds"}[
                    tc.frontend]] = (rows, None, None)
            assert got == want, (arch, sname)


def test_spec_placements():
    """A spec on a real (fake-group) mesh: Shard(d) on each mesh dim entry d
    names, in the mesh's order; axes out of the mesh's order refused."""
    code = textwrap.dedent("""
        import torch.distributed as dist
        from torch.distributed.tensor import Replicate, Shard
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.parallel.sharding import P, spec_placements
        m = make_smoke_mesh((2, 2, 2), ("data", "a", "b"), device="cpu")
        assert spec_placements(P(None, ("a", "b")), m) == [
            Replicate(), Shard(1), Shard(1)]
        assert spec_placements(P("data", None, "b"), m) == [
            Shard(0), Replicate(), Shard(2)]
        assert spec_placements(P(), m) == [Replicate()] * 3
        import pytest
        with pytest.raises(ValueError, match="mesh's order"):
            spec_placements(P(("b", "a")), m)
        with pytest.raises(RuntimeError, match="needs 16 ranks"):
            make_smoke_mesh((4, 4), device="cpu")
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ,
                            "PYTHONPATH": os.path.join(ROOT, "src")})
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]


# ---------------------------------------------------------------------------
# what the port does not distribute yet: refused, never run unsharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b", "whisper-base",
                                  "phi-3-vision-4.2b"])
def test_unported_families_under_a_mesh_raise(arch):
    from repro_torch.models import transformer as TT
    from repro_torch.models.context import ModelContext
    cfg = tcfg.reduced(tcfg.get_config(arch), dtype="float32")
    ctx = ModelContext(mesh=object())       # refused before the mesh is used
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        TT.forward({}, cfg, torch.zeros((1, 8), dtype=torch.long), ctx=ctx)


@pytest.mark.parametrize("entry", ["prefill", "decode_step"])
def test_decode_under_a_mesh_raises(entry):
    from repro_torch.models.context import ModelContext
    from repro_torch.serve import decode
    cfg = tcfg.reduced(tcfg.get_config("tinyllama-1.1b"), dtype="float32")
    ctx = ModelContext(mesh=object())
    tok = torch.zeros((1, 4), dtype=torch.long)
    call = {"prefill": lambda: decode.prefill({}, cfg, tok, 8, ctx=ctx),
            "decode_step": lambda: decode.decode_step({}, cfg, tok[:, :1],
                                                      {}, ctx=ctx)}[entry]
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        call()


def test_dryrun_cli_refuses_until_slice_7(capsys):
    with pytest.raises(SystemExit) as e:
        TD.main([])
    assert e.value.code == 2
    assert "slice 7" in capsys.readouterr().err

"""The port's meshes, placements, constraints and health probe against
the JAX package, in one process on the CPU (the gangs themselves:
``tests/test_torch_gang.py`` and ``tests/test_torch_gang_run.py``).

- ``MeshSpec.resolve`` fills and refuses as the reference does, with its
  messages; the num_slices check and layout (dp across slices, a slice
  a block of consecutive ranks) match ``tests/test_multislice.py``.
- With no process group a mesh is this process's one device: a spec
  naming more raises the reference's ``MeshError``.
- The placement rule marks the same leaves as sharded over fsdp as
  the reference's ``make_param_shardings`` on a ``dp=1, fsdp=2`` mesh
  (the reference's flags carried to the port's names by ``convert.py``),
  for the zoo at ``fsdp_min_size`` 2**16 and 2**10.
- ``check_slice_health`` reports a healthy device, a hung probe and a
  probe error, as ``tests/test_failure_detection.py`` checks the
  reference's.
- ``constrain`` is the identity, the serving-exact mesh, tensor,
  expert, sequence and pipeline axes taken (fsdp beside them too, tp
  beside the pipeline), the pipeline beside ep or sp refused by the
  reference's message, and every collective is the identity with no
  mesh.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.parallel import mesh as jmesh
from polyaxon_tpu.parallel.strategies import make_param_shardings
from polyaxon_tpu_torch import convert
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from polyaxon_tpu_torch.parallel import collectives as tcoll
from polyaxon_tpu_torch.parallel import constraints as tcon
from polyaxon_tpu_torch.parallel import health as thealth
from polyaxon_tpu_torch.parallel import mesh as tmesh
from polyaxon_tpu_torch.parallel import strategies as tstrat

torch.set_num_threads(2)


def _error(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("axes,n", [
    ({"dp": -1, "tp": 2}, 8), ({"dp": 3, "tp": 1, "fsdp": 1}, 8),
    ({"dp": -1, "fsdp": -1}, 4), ({"dp": 2}, 1), ({"dp": 2, "fsdp": 2}, 4),
    ({"fsdp": 3}, 8), ({"dp": 1, "fsdp": -1}, 2), ({"bogus": 2}, 2)])
def test_mesh_spec_resolves_as_reference(axes, n):
    def resolve(mod):
        return mod.MeshSpec.from_dict(axes).resolve(n)

    assert _error(resolve, tmesh) == _error(resolve, jmesh)
    if _error(resolve, jmesh) is None:
        assert resolve(tmesh) == resolve(jmesh)
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.logical_axis_rules() == jmesh.logical_axis_rules()


def test_num_slices_layout_and_check_match_reference():
    devices = jax.devices()
    with pytest.raises(jmesh.MeshError, match="num_slices") as want:
        jmesh.build_mesh(jmesh.MeshSpec(dp=3, num_slices=2),
                         devices=devices[:3])
    with pytest.raises(tmesh.MeshError) as got:
        tmesh.build_mesh(tmesh.MeshSpec(dp=3, num_slices=2),
                         devices=["cpu"] * 3)
    assert str(got.value) == str(want.value)
    sizes, ranks = tmesh.mesh_layout(
        tmesh.MeshSpec(dp=4, fsdp=2, num_slices=2), 8)
    ref = jmesh.build_mesh(jmesh.MeshSpec(dp=4, fsdp=2, num_slices=2),
                           devices=devices[:8])
    assert sizes == dict(ref.shape)
    # dp is outermost: slice s (dp rows 2s, 2s+1) is a block of
    # consecutive ranks.
    assert ranks.shape == (4, 2, 1, 1, 1, 1)
    for s in range(2):
        assert sorted(ranks[2 * s:2 * s + 2].ravel()) == \
            list(range(4 * s, 4 * s + 4))


def test_groupless_mesh_is_one_device():
    mesh = tmesh.build_mesh(tmesh.MeshSpec(dp=-1), device="cpu")
    assert not mesh.is_distributed and mesh.devices.size == 1
    assert mesh.shape == {a: 1 for a in tmesh.AXIS_ORDER}
    assert mesh.group("dp") is None
    assert tmesh.data_sharding(mesh) == tmesh.DataSharding(
        torch.device("cpu"), 0, 1)
    want = _error(lambda: jmesh.MeshSpec(dp=2).resolve(1))
    assert want is not None
    assert _error(lambda: tmesh.build_mesh(tmesh.MeshSpec(dp=2),
                                           device="cpu")) == want
    with pytest.raises(tmesh.MeshError, match="one process per device"):
        tmesh.build_mesh(tmesh.MeshSpec(dp=-1), devices=["cpu", "cpu"])


def test_data_sharding_rows_are_the_references_blocks():
    """Rank r of a (dp, fsdp) mesh holds block dp_r * fsdp + fsdp_r of
    the batch, as the reference's ``P(("dp", "fsdp"))`` lays it out."""
    sizes = {"dp": 2, "fsdp": 2, "pp": 1, "sp": 1, "ep": 1, "tp": 1}
    ranks = np.arange(4).reshape(2, 2, 1, 1, 1, 1)
    rows = np.arange(8)
    got = []
    for r in range(4):
        m = tmesh.Mesh(sizes, ranks, torch.device("cpu"), rank=r)
        got.append(tmesh.data_sharding(m).shard(rows).tolist())
    assert got == [[0, 1], [2, 3], [4, 5], [6, 7]]
    ref = jmesh.build_mesh(jmesh.MeshSpec(dp=2, fsdp=2),
                           devices=jax.devices()[:4])
    arr = jax.device_put(jnp.arange(8), jmesh.data_sharding(ref))
    want = [np.asarray(s.data).tolist() for s in sorted(
        arr.addressable_shards, key=lambda s: s.index[0].start)]
    assert got == want
    with pytest.raises(ValueError, match="multiple of dp x fsdp"):
        tmesh.data_sharding(tmesh.Mesh(sizes, ranks, torch.device("cpu"))
                            ).shard(np.arange(6))


CONVERT = {
    "gpt2-tiny": convert.gpt2_state_dict_from_jax,
    "llama-tiny": convert.llama_state_dict_from_jax,
    "bert-tiny": convert.bert_state_dict_from_jax,
    "moe-gpt-tiny": convert.moe_gpt_state_dict_from_jax,
    "t5-tiny": convert.t5_state_dict_from_jax,
    "vit-tiny": convert.vit_state_dict_from_jax,
    "resnet50-tiny": convert.resnet_state_dict_from_jax,
    "convnet": convert.convnet_state_dict_from_jax,
    "mlp": convert.mlp_state_dict_from_jax,
}


@pytest.mark.parametrize("min_size", [2 ** 16, 2 ** 10])
@pytest.mark.parametrize("name", sorted(CONVERT))
def test_placements_mark_the_references_sharded_leaves(name, min_size):
    """Each flax leaf becomes 1 where the reference shards it over fsdp
    and 0 where it replicates it; through the converter every port
    parameter must be all 1 exactly where the placement shards it."""
    jspec = j_get_model(name)
    jmodel = jspec.make_model(dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x),
        jspec.make_batch(2)["inputs"])
    ref = jmesh.build_mesh(jmesh.MeshSpec(dp=1, fsdp=2),
                           devices=jax.devices()[:2])
    shard = make_param_shardings(shapes["params"], ref,
                                 fsdp_min_size=min_size)
    flags = jax.tree.map(
        lambda leaf, sh: np.full(leaf.shape, float(
            any(a is not None for a in sh.spec)), np.float32),
        shapes["params"], shard)
    model = t_get_model(name).make_model(device="cpu",
                                         param_dtype=torch.float32)
    args = (flags, model.cfg)
    if "batch_stats" in shapes:
        args += (jax.tree.map(lambda l: np.zeros(l.shape, np.float32),
                              shapes["batch_stats"]),)
    want = CONVERT[name](*args)
    mesh = tmesh.Mesh({"dp": 1, "fsdp": 2, "pp": 1, "sp": 1, "ep": 1,
                       "tp": 1}, np.arange(2).reshape(1, 2, 1, 1, 1, 1),
                      torch.device("cpu"), spec=tmesh.MeshSpec(dp=1, fsdp=2))
    got = tstrat.make_param_placements(model, mesh, fsdp_min_size=min_size)
    checked = 0
    for pname, dim in got.items():
        if pname not in want:     # a port-only leaf (bert's type_embed)
            continue
        w = want[pname].float()
        assert bool((w == w.flatten()[0]).all()), pname
        assert (dim is not None) == bool(w.flatten()[0]), \
            f"{pname}: port {dim}, reference sharded {bool(w[0].any())}"
        checked += 1
    assert checked >= len(got) - 1    # every parameter but type_embed
    if min_size == 2 ** 10 and name != "mlp":
        assert any(d is not None for d in got.values())


def test_placement_rule_on_stacked_and_conv_leaves():
    """The fsdp branch of the reference's ``infer_param_spec`` on the
    flax leaf (a scanned block's leaf with its layer axis first), and
    its port dims through ``make_placements``."""
    spec = tstrat.infer_param_spec
    # GPT-2 medium's fc1 bias: [4096] a layer, [24, 4096] stacked in the
    # reference (98304 elements): sharded, on the bias's own dim.
    assert spec("h_0/fc1/bias", (24, 4096), fsdp=True) == (None, "fsdp")
    assert spec("h_0/fc1/bias", (4096,), fsdp=True) == (None,)
    # A Dense kernel [in, out]: its larger dim; ties the earlier (in).
    assert spec("fc1/kernel", (1024, 4096), fsdp=True) == (None, "fsdp")
    assert spec("fc2/kernel", (4096, 1024), fsdp=True) == ("fsdp", None)
    assert spec("proj/kernel", (1024, 1024), fsdp=True) == ("fsdp", None)
    # A conv kernel (kh, kw, in, out): in or out, never the window.
    assert spec("conv/kernel", (3, 3, 128, 256), fsdp=True) == \
        (None, None, None, "fsdp")
    assert spec("conv/kernel", (3, 3, 256, 128), fsdp=True) == \
        (None, None, "fsdp", None)
    # The stacked leaf's layer axis is its largest: the reference shards
    # it (the port keeps such a leaf replicated: no layer axis).
    assert spec("h_0/ln/scale", (8192, 16), fsdp=True) == ("fsdp", None)
    assert spec("proj/kernel", (64, 64)) == (None, None)
    # Port dims: a Dense weight is [out, in], a conv's (out, in, kh, kw).
    model = t_get_model("gpt2-medium").make_model(device="meta")
    mesh = tmesh.Mesh({"dp": 1, "fsdp": 2, "pp": 1, "sp": 1, "ep": 1,
                       "tp": 1}, np.arange(2).reshape(1, 2, 1, 1, 1, 1),
                      torch.device("cpu"), spec=tmesh.MeshSpec(dp=1, fsdp=2))
    got = tstrat.make_param_placements(model, mesh)
    assert (got["h.0.fc1.bias"], got["h.0.fc1.weight"],
            got["h.0.fc2.weight"], got["h.0.o_proj.weight"],
            got["h.0.ln1.weight"], got["wte.weight"]) == (0, 0, 1, 1, None,
                                                          None)


def test_slice_health_healthy_hung_and_error(monkeypatch):
    health = thealth.check_slice_health(timeout_s=60)
    assert health.ok and health.n_devices == 1, health.detail
    assert health.latency_s is not None and health.detail == \
        "1 devices healthy"

    real_ones = torch.ones

    def hanging_ones(*args, **kwargs):
        time.sleep(30)
        return real_ones(*args, **kwargs)

    monkeypatch.setattr(torch, "ones", hanging_ones)
    start = time.monotonic()
    health = thealth.check_slice_health(timeout_s=0.5)
    assert time.monotonic() - start < 5
    assert not health.ok and "hung" in health.detail
    assert health.latency_s is None

    def broken_ones(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(torch, "ones", broken_ones)
    health = thealth.check_slice_health(timeout_s=5)
    assert not health.ok and "illegal memory access" in health.detail


def test_constraints_and_collectives_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert tcon.current_mesh() is None
    assert tcon.constrain(x, tcon.BATCH, None, "tp") is x
    mesh = tmesh.build_mesh(device="cpu")
    with tcon.ambient_mesh(mesh):
        assert tcon.current_mesh() is mesh
        assert tcon.constrain(x, tcon.BATCH) is x
    assert tcon.current_mesh() is None
    # The serving-exact mesh: a contextvar, and a tensor-axis site
    # replicates on the group's primary device (column shards
    # concatenated), every other site stays the identity.
    from polyaxon_tpu_torch.serving.meshed import ServingMesh

    group = ServingMesh("tp=2", devices=["cpu"] * 2).group(0)
    assert tcon.current_exact_mesh() is None
    with tcon.exact_mesh(group):
        assert tcon.current_exact_mesh() is group
        assert tcon.constrain(x, tcon.BATCH) is x
        cat = tcon.constrain([x, x + 1], tcon.BATCH, None, "tp")
        assert torch.equal(cat, torch.cat([x, x + 1], -1))
    assert tcon.current_exact_mesh() is None
    with tcon.exact_mesh(None):
        assert tcon.current_exact_mesh() is None
    for fn in (lambda t: tcoll.all_reduce(t, ("dp", "fsdp")),
               lambda t: tcoll.all_reduce_mean(t, "dp"),
               lambda t: tcoll.reduce_scatter(t, "fsdp"),
               lambda t: tcoll.all_gather(t, "fsdp"),
               lambda t: tcoll.all_to_all(t, "dp", split_dim=1,
                                          concat_dim=0),
               lambda t: tcoll.ring_permute(t, "fsdp"),
               lambda t: tcoll.hierarchical_all_reduce(t)):
        assert torch.equal(fn(x), x)
    assert tcoll.data_shard() == (0, 1)


@pytest.mark.parametrize("axis", ["tp", "ep", "sp", "pp"])
def test_tensor_axes_refused_by_parallelism_item(axis):
    """tp, ep, sp and pp are ported (``test_torch_tp.py``,
    ``test_torch_ep.py``, ``test_torch_sp.py``,
    ``test_torch_pipeline.py``) and compose with fsdp
    (``test_torch_compose.py``): a train step takes their mesh and the
    mesh with fsdp beside, and pp beside tp or dp; pp beside ep or sp
    stays refused by the reference's message."""
    def mesh_of(**axes):
        sizes = dict({a: 1 for a in tmesh.AXIS_ORDER}, **axes)
        return tmesh.Mesh(sizes, np.arange(int(np.prod(list(
            sizes.values())))).reshape([sizes[a] for a in tmesh.AXIS_ORDER]),
            torch.device("cpu"))

    meshes = [mesh_of(**{axis: 2}), mesh_of(fsdp=2, **{axis: 2})]
    if axis in ("tp", "pp"):
        meshes += [mesh_of(pp=2, tp=2), mesh_of(dp=2, pp=2)]
    for mesh in meshes:
        step = tstrat.TrainStep(lambda b, r: None, None, mesh)
        assert step.mesh is mesh and not step.distributed
    if axis in ("ep", "sp"):
        with pytest.raises(NotImplementedError,
                           match=f"strategy combines pp>1 with {axis}>1"):
            tstrat.TrainStep(lambda b, r: None, None,
                             mesh_of(pp=2, **{axis: 2}))

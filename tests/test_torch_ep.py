"""Expert parallelism in training: the port's ``moe_layer`` and
MoE-GPT's train step over gloo gangs against the JAX reference on the
CPU (the reference on the conftest's virtual host devices, as in
``test_torch_tp.py``).

- ``moe_layer`` on ``ep:2`` and on ``dp:2,ep:2`` against the reference's
  ``moe_layer`` on the same mesh, at capacity factor 1.25 (each rank's
  capacity from its own tokens: tokens drop, and the layer is NOT the
  one-device layer) and at full capacity (nothing drops: the dense
  layer): each rank's output rows and ``aux`` (the mean of the ranks'
  load-balance terms), and, for the loss ``sum(out * G) / n_data + 0.5
  aux``, the router's gradient (summed over ep, averaged over the data
  axes, as the train step reduces it), each rank's experts' gradient
  and the input's, all within 1e-5 of the largest magnitude (float32;
  the all-to-all reorders no sum, the gradients' sums over ep and the
  data axes do).
- Meshless ``moe_layer`` is the dense path (``test_torch_moe.py``).
- MoE-GPT tiny's two AdamW steps on ``dp:2,ep:2`` against the
  reference's ``TrainStep`` on ``MeshSpec(dp=2, ep=2)``: loss,
  ``grad_norm`` and ``aux_loss`` (rtol 1e-5) and the parameters (the
  Adam rule of ``test_torch_gang.py``); the gradients of the parameters
  not sharded (the router's after its ep sum) agree across the ep
  ranks.
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.parallel import MeshSpec, build_mesh
from polyaxon_tpu.parallel.moe import moe_layer as j_moe_layer
from polyaxon_tpu.parallel.moe import top1_dispatch as j_top1_dispatch
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from test_torch_gang import run_gang
from test_torch_tp import _case, _check, _reference, gang_runs

torch.set_num_threads(2)

B, S, D, E, F = 4, 16, 8, 4, 12
AUX = 0.5

MOE_WORKER = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from polyaxon_tpu_torch.parallel import (MeshSpec, build_mesh,
    initialize_from_env)
from polyaxon_tpu_torch.parallel.mesh import data_sharding
from polyaxon_tpu_torch.parallel.moe import moe_layer
from polyaxon_tpu_torch.parallel.strategies import all_reduce_grads

topo = initialize_from_env(device="cpu")
for run in json.load(open(sys.argv[1])):
    mesh = build_mesh(MeshSpec.from_dict(run["strategy"]), device="cpu")
    d = dict(np.load(run["data"]))
    ep, me = mesh.shape["ep"], mesh.coordinate("ep")
    sh = data_sharding(mesh)
    x = torch.as_tensor(sh.shard(d["x"])).requires_grad_(True)
    g = torch.as_tensor(sh.shard(d["g"]))
    router = torch.as_tensor(d["router"]).requires_grad_(True)
    w1, w2 = (torch.as_tensor(d[k]).chunk(ep)[me].clone()
              .requires_grad_(True) for k in ("w1", "w2"))
    out, aux = moe_layer(x, router, w1, w2, mesh,
                         capacity_factor=run["cf"])
    ((out * g).sum() + run["aux"] * aux).backward()
    # The train step's reductions: every gradient's mean over the data
    # axes, the router's sum over ep.
    all_reduce_grads([router.grad, w1.grad, w2.grad], mesh)
    dist.all_reduce(router.grad, group=mesh.group("ep"))
    torch.save({"out": out.detach(), "aux": float(aux),
                "router": router.grad, "w1": w1.grad, "w2": w2.grad,
                "x": x.grad, "rows": sh.rows(len(d["x"])), "ep": me,
                "count": sh.count}, f"{run['out']}.{topo.process_id}.pt")
print("ok", flush=True)
"""


def _data(tmp_path, tag):
    rs = np.random.RandomState(3)
    d = {"x": rs.randn(B, S, D), "g": rs.randn(B, S, D),
         "router": rs.randn(D, E), "w1": 0.3 * rs.randn(E, D, F),
         "w2": 0.3 * rs.randn(E, F, D)}
    d = {k: v.astype(np.float32) for k, v in d.items()}
    path = tmp_path / f"{tag}.npz"
    np.savez(path, **d)
    return d, str(path)


def _reference_layer(d, dp, ep, cf):
    """The reference's output, aux and gradients of ``sum(out * G) / dp
    + AUX * aux`` on ``MeshSpec(dp, ep)``."""
    mesh = build_mesh(MeshSpec(dp=dp, ep=ep), devices=jax.devices()[:dp * ep])

    def loss(x, r, w1, w2):
        out, aux = j_moe_layer(x, r, w1, w2, mesh, capacity_factor=cf)
        return (out * d["g"]).sum() / dp + AUX * aux, (out, aux)

    with jax.default_matmul_precision("highest"):
        grads, (out, aux) = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3),
                                             has_aux=True))(
            *(jnp.asarray(d[k]) for k in ("x", "router", "w1", "w2")))
    return np.asarray(out), float(aux), [np.asarray(g) for g in grads]


def _near(got, want, what, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-12), err_msg=what)


def _drops(d, dp, ep, cf) -> int:
    """Tokens dropped over the ranks' capacities (the reference's
    dispatch of each rank's tokens: its rows, its 1/ep of the
    sequence)."""
    dropped = 0
    rows, chunk = B // dp, S // ep
    for b in range(dp):
        for e in range(ep):
            xl = d["x"][b * rows:(b + 1) * rows,
                        e * chunk:(e + 1) * chunk].reshape(-1, D)
            cap = max(1, int(cf * len(xl) / E))
            disp, _, _ = j_top1_dispatch(jnp.asarray(xl @ d["router"]), cap)
            dropped += len(xl) - int(np.asarray(disp).sum())
    return dropped


@pytest.mark.parametrize("axes", [{"dp": 1, "ep": 2}, {"dp": 2, "ep": 2}],
                         ids=["ep2", "dp2-ep2"])
def test_moe_layer_over_a_gang_equals_reference(tmp_path, axes):
    d, data = _data(tmp_path, "moe")
    cases = [("drop", 1.25), ("full", float(E))]
    runs = [dict(strategy=axes, data=data, cf=cf, aux=AUX,
                 out=str(tmp_path / tag)) for tag, cf in cases]
    n = axes["dp"] * axes["ep"]
    cfg = tmp_path / "moe.json"
    cfg.write_text(json.dumps(runs))
    script = tmp_path / "moe_worker.py"
    script.write_text(MOE_WORKER)
    outs = run_gang([sys.executable, str(script), str(cfg)], n, tmp_path)
    assert all(o.strip().endswith("ok") for o in outs), outs
    # Per-rank capacities drop tokens at 1.25; none at E.
    assert _drops(d, axes["dp"], axes["ep"], 1.25) > 0
    assert _drops(d, axes["dp"], axes["ep"], float(E)) == 0
    el = E // axes["ep"]
    for (tag, cf), run in zip(cases, runs):
        out, aux, (gx, gr, g1, g2) = _reference_layer(d, axes["dp"],
                                                      axes["ep"], cf)
        for r in range(n):
            got = torch.load(f"{run['out']}.{r}.pt", weights_only=False)
            rows, me = got["rows"], got["ep"]
            _near(got["out"], out[rows], f"{tag} out")
            assert abs(got["aux"] - aux) <= 1e-6 * abs(aux), (tag, aux)
            _near(got["router"], gr, f"{tag} router")
            _near(got["w1"], g1[me * el:(me + 1) * el], f"{tag} w1")
            _near(got["w2"], g2[me * el:(me + 1) * el], f"{tag} w2")
            # Each rank's input gradient is its data group's; the
            # reference's loss is their mean.
            _near(got["x"] / got["count"], gx[rows], f"{tag} x")


def test_moe_gpt_dp2_ep2_gang_trains_as_the_reference(tmp_path):
    jmodel, variables, sd, batch = _case("moe-gpt-tiny", seq=32)
    weights, data = tmp_path / "w.pt", tmp_path / "b.npz"
    torch.save(sd, weights)
    np.savez(data, **batch)
    out = gang_runs(tmp_path, [dict(
        model="moe-gpt-tiny", weights=str(weights), batch=str(data),
        strategy={"dp": 2, "ep": 2}, lr=1e-3, steps=2,
        out=str(tmp_path / "m"))], 4)[0]
    want = _reference("moe-gpt-tiny", jmodel, variables, batch, 2, dp=2,
                      tp=1, ep=2)
    cfg = t_get_model("moe-gpt-tiny").make_model(device="meta").cfg
    _check("moe-gpt-tiny", out, *want, cfg, axis="ep",
           keys=("loss", "grad_norm", "aux_loss"))
    assert sorted(out[0]["shards"]) == [
        f"h.{i}.moe.experts_w{j}" for i in range(2) for j in (1, 2)]

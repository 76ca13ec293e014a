"""The port's training path against the JAX package's, fp32 on the CPU, on
tiny twins with the reference's own initial weights carried over by the
bridge:

  * ``sharded_xent`` value and gradient at tp 1 and 2; ``warmup_cosine``
    and ``adamw_update`` (grad-clip invariance included) and
    ``zero1_update_local`` given the reference's gradients;
  * ``make_training_batch`` draws the reference's batches bit for bit, for
    every family;
  * one step's gradients against ``jax.grad`` of the reference's loss
    (dense, MoE and VLM twins at tp=1; rtol 1e-4, atol 1e-6);
  * 4-step loss and gradient-norm trajectories against the reference's
    ``make_train_step`` (rtol 1e-4), remat on and off (the hybrid, xLSTM
    and whisper twins with remat on);
  * a data=2 x model=2 grid of gloo ranks: the reduced per-leaf gradients
    equal the reference's on its 2 x 2 mesh, which are twice those of its
    2 x 1 mesh (``lax.psum`` transposes to ``psum`` under
    ``check_vma=False``: ROADMAP queue C); the plain, ZeRO-1 and int8
    gradient-mean trajectories equal the reference's; ZeRO-1's parameters
    equal plain AdamW's;
  * checkpoints: a bf16 round trip bit for bit, and a restore of a
    checkpoint the reference wrote;
  * ``launch/train.py --preset tiny`` on the CPU.

The reference's 2 x 2 and 2 x 1 runs need four host devices, so one JAX
subprocess (``--xla_force_host_platform_device_count=4``) computes every
reference variant; one spawn of four ranks runs every port variant."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from conftest import ALL_TINY, tiny_dense, tiny_hybrid, tiny_moe, \
    tiny_vlm, tiny_whisper, tiny_xlstm  # noqa: E402
from repro.config import Config as RConfig  # noqa: E402
from repro.config import ParallelConfig as RParallel  # noqa: E402
from repro.config import RuntimeConfig as RRuntime  # noqa: E402
from repro.core.overlap import AxisCtx as RAxisCtx  # noqa: E402
from repro.launch.mesh import local_test_mesh  # noqa: E402
from repro.models import api as r_api  # noqa: E402
from repro.training import checkpoint as r_ckpt  # noqa: E402
from repro.training import optimizer as r_opt  # noqa: E402
from repro.training.data import make_training_batch as r_batch  # noqa: E402
from repro.training.loss import sharded_xent as r_xent  # noqa: E402
from repro.training.trainer import init_train_state as r_init  # noqa: E402
from repro.training.trainer import make_train_step as r_step  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.config import Config, ModelConfig, MoEConfig, \
    ParallelConfig, RuntimeConfig, SSMConfig  # noqa: E402
from repro_torch.core.overlap import AxisCtx  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import decoder  # noqa: E402
from repro_torch.training import checkpoint, optimizer, trainer  # noqa: E402
from repro_torch.training.data import make_training_batch  # noqa: E402
from repro_torch.training.loss import sharded_xent  # noqa: E402
from repro_torch.training.zero import zero1_init_local, \
    zero1_update_local  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-4


def port_cfg(ref_cfg) -> ModelConfig:
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    if ref_cfg.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(ref_cfg.moe))
    if ref_cfg.ssm is not None:
        kw["ssm"] = SSMConfig(**dataclasses.asdict(ref_cfg.ssm))
    return ModelConfig(**kw)


TWINS = {"dense": tiny_dense(), "moe": tiny_moe(), "vlm": tiny_vlm(),
         "hybrid": tiny_hybrid(), "xlstm": tiny_xlstm(),
         "whisper": tiny_whisper()}


def _configs(ref_cfg, remat=False, **rt):
    rt = dict(dict(mode="train", max_steps=20, warmup_steps=1, remat=remat),
              **rt)
    ref = RConfig(model=ref_cfg, parallel=RParallel(data=1, model=1),
                  runtime=RRuntime(**rt))
    port = Config(model=port_cfg(ref_cfg),
                  parallel=ParallelConfig(data=1, model=1),
                  runtime=RuntimeConfig(**rt))
    return ref, port


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf_arrays(leaf):
    """A port ``Leaf``'s tensors as the reference's (stacked) array."""
    arrs = [t.detach().float().numpy() for t in leaf.tensors]
    return np.stack(arrs) if leaf.ndim > leaf.tensors[0].ndim else arrs[0]


# ---------------------------------------------------------------------------
# loss, schedule, optimizer, data
# ---------------------------------------------------------------------------

def test_sharded_xent_value_and_grad_tp1():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 8, 64)).astype(np.float32) * 3
    labels = rng.integers(0, 64, (2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want, gwant = jax.value_and_grad(lambda x: r_xent(
            x, jnp.asarray(labels), RAxisCtx(),
            mask=None if m is None else jnp.asarray(m)))(jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        got = sharded_xent(x, torch.from_numpy(labels), AxisCtx(),
                           mask=None if m is None else torch.from_numpy(m))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(gwant),
                                   rtol=1e-5, atol=1e-7)


def test_warmup_cosine_matches_reference():
    for step in (0, 1, 5, 10, 37, 100, 250):
        want = r_opt.warmup_cosine(jnp.int32(step), 3e-4, 10, 200)
        got = optimizer.warmup_cosine(step, 3e-4, 10, 200)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 1e-3, 0.0])
def test_adamw_update_matches_reference(clip):
    """The reference's gradients through both updates, three steps; a clip
    of 1e-3 scales every gradient, 0.0 turns clipping off."""
    rng = np.random.default_rng(1)
    shapes = [(8, 16), (16,), (4, 8, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    r_p, r_s = list(map(jnp.asarray, params)), None
    r_s = r_opt.adamw_init(r_p)
    p = [torch.from_numpy(x.copy()) for x in params]
    s = optimizer.adamw_init(p)
    for step in range(3):
        grads = [rng.standard_normal(x.shape).astype(np.float32) * 0.3
                 for x in params]
        r_p, r_s = r_opt.adamw_update(r_p, list(map(jnp.asarray, grads)),
                                      r_s, lr=1e-2, weight_decay=0.1,
                                      grad_clip=clip)
        optimizer.adamw_update(p, [torch.from_numpy(g) for g in grads], s,
                               lr=1e-2, weight_decay=0.1, grad_clip=clip)
        assert s.step == int(r_s.step) == step + 1
        for a, b in zip(p, r_p):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        for a, b in zip(s.nu, r_s.nu):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)


@pytest.mark.parametrize("make", ALL_TINY, ids=lambda f: f.__name__)
def test_make_training_batch_bit_equal(make):
    ref_cfg = make()
    for step in (0, 3):
        want = r_batch(ref_cfg, 48, 3, step, seed=2)
        got = make_training_batch(port_cfg(ref_cfg), 48, 3, step, seed=2)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# gradients and trajectories at tp=1
# ---------------------------------------------------------------------------

def _ref_state(ref_config):
    m = local_test_mesh(1, 1)
    params, opt = r_init(ref_config, m, jax.random.PRNGKey(0),
                         dtype=jnp.float32)
    return m, params, opt


@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_one_step_gradients_match_jax_grad(family):
    ref_cfg = TWINS[family]
    ref_config, config = _configs(ref_cfg, remat=True)
    _, params, _ = _ref_state(ref_config)
    batch = r_batch(ref_cfg, 32, 4, 0)
    iso = dataclasses.replace(ref_config.iso, enabled=False)

    def loss_fn(p, b):
        out = r_api.prefill(p, ref_cfg, RAxisCtx(), iso, b,
                            logits_mode="all", remat=True)
        lg = out["logits_local"]
        if ref_cfg.family == "vlm":
            lg = lg[:, b["patches"].shape[1]:]
        return r_xent(lg, b["labels"], RAxisCtx()) + 0.01 * out["moe_aux"]

    want_loss, want = jax.value_and_grad(loss_fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    step = trainer.make_train_step(config)
    loss, leaves, grads = step.grads(bridge.from_reference(_np_tree(params)),
                                     batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat] == \
        [leaf.name for leaf in leaves]
    for (_, g), leaf, gs in zip(flat, leaves, grads):
        np.testing.assert_allclose(
            _leaf_arrays(dataclasses.replace(leaf, tensors=list(gs))),
            np.asarray(g), rtol=RTOL, atol=1e-6, err_msg=leaf.name)


def _trajectories(ref_cfg, remat, steps=4):
    ref_config, config = _configs(ref_cfg, remat=remat)
    m, params, opt = _ref_state(ref_config)
    port_params = bridge.from_reference(_np_tree(params))
    step_fn, *_ = r_step(ref_config, m, jax.eval_shape(lambda: params))
    p_step = trainer.make_train_step(config)
    _, p_opt = trainer.init_train_state(config, params=port_params)
    want, got = [], []
    with m:
        for s in range(steps):
            b = r_batch(ref_cfg, 32, 4, s)
            params, opt, loss, gn = step_fn(
                params, opt, {k: jnp.asarray(v) for k, v in b.items()},
                jnp.int32(s))
            want.append((float(loss), float(gn)))
            loss, gn = p_step(port_params, p_opt, make_training_batch(
                port_cfg(ref_cfg), 32, 4, s), s)
            got.append((float(loss), float(gn)))
    return np.array(got), np.array(want)


@pytest.mark.parametrize("family,remat", [("dense", False), ("dense", True),
                                          ("moe", True), ("vlm", True),
                                          ("hybrid", True), ("xlstm", True),
                                          ("whisper", True)])
def test_trajectories_match_make_train_step(family, remat):
    got, want = _trajectories(TWINS[family], remat)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[-1, 0] < got[0, 0]


def test_zero1_update_given_reference_grads():
    """The reference's gradients through both ZeRO-1 updates at dp=1 (the
    state is each whole stacked leaf); the port's leaves are the
    reference's."""
    from repro import compat
    from repro.models.decoder import decoder_param_specs
    from repro.training.zero import zero1_init_local as r_zinit
    from repro.training.zero import zero1_update_local as r_zupd
    from jax.sharding import PartitionSpec as P
    ref_config, config = _configs(tiny_dense())
    m, params, _ = _ref_state(ref_config)
    specs = decoder_param_specs(jax.eval_shape(lambda: params))
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(
            np.float32) * 0.01), params)
    is_p = lambda x: isinstance(x, P)              # noqa: E731
    rep = jax.tree_util.tree_map(lambda _: P(), specs, is_leaf=is_p)

    def run(p, g):
        st = r_zinit(p, 1)
        for _ in range(2):
            p, st, gn = r_zupd(p, g, st, specs, tp_axis=None,
                               dp_axes=("data",), dp=1, lr=1e-3,
                               weight_decay=0.1, grad_clip=1.0)
        return p, st, gn

    with m:
        want_p, want_st, want_gn = jax.jit(compat.shard_map(
            run, mesh=m, in_specs=(rep, rep),
            out_specs=(rep, P(), P()), check_vma=False))(params, grads)
    port = bridge.from_reference(_np_tree(params))
    leaves = trainer.param_leaves(port)
    pg = bridge.from_reference(_np_tree(grads))
    g_leaves = trainer.param_leaves(pg)
    st = zero1_init_local(leaves, 1)
    for _ in range(2):
        gn = zero1_update_local(leaves, [l.tensors for l in g_leaves], st,
                                AxisCtx(), lr=1e-3, weight_decay=0.1,
                                grad_clip=1.0)
    np.testing.assert_allclose(float(gn), float(want_gn), rtol=1e-6)
    for leaf, w in zip(leaves, jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_allclose(_leaf_arrays(leaf), np.asarray(w),
                                   rtol=1e-6, atol=1e-6, err_msg=leaf.name)
    for mu, w in zip(st.mu, jax.tree_util.tree_leaves(want_st.mu)):
        np.testing.assert_allclose(mu.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# data=2 x model=2 over gloo against the reference's 4-device mesh
# ---------------------------------------------------------------------------

_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.config import Config, ModelConfig, ParallelConfig, RuntimeConfig
from repro.core.overlap import AxisCtx
from repro.launch.mesh import make_mesh
from repro.models import api
from repro.models.decoder import decoder_param_specs
from repro.training.data import make_training_batch
from repro.training.loss import sharded_xent
from repro.training.trainer import (init_train_state, make_train_step,
                                    make_axis_ctx, batch_specs, _grad_reduce)

out = sys.argv[1]
cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                  qk_norm=True)
res = {}

def config(data, model, **rt):
    return Config(model=cfg, parallel=ParallelConfig(data=data, model=model),
                  runtime=RuntimeConfig(mode="train", max_steps=20,
                                        warmup_steps=1, remat=False, **rt))

# per-leaf reduced gradients of step 0 (global arrays), 2 x 2 and 2 x 1
batch0 = {k: jnp.asarray(v)
          for k, v in make_training_batch(cfg, 32, 8, 0).items()}
for data, model in ((2, 2), (2, 1)):
    c = config(data, model)
    m = make_mesh(c.parallel)
    params, _ = init_train_state(c, m, jax.random.PRNGKey(0),
                                 dtype=jnp.float32)
    if (data, model) == (2, 2):
        for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
            res["init" + jax.tree_util.keystr(path)] = np.asarray(x)
    specs = decoder_param_specs(jax.eval_shape(lambda: params))
    ctx = make_axis_ctx(c)
    iso = c.iso.__class__(**{**c.iso.__dict__, "enabled": False})

    def local(p, b):
        def loss_fn(p):
            o = api.prefill(p, cfg, ctx, iso, b, logits_mode="all")
            return sharded_xent(o["logits_local"], b["labels"], ctx)
        g = jax.grad(loss_fn)(p)
        return _grad_reduce(g, specs, ctx, dp_sizes=(data,))

    fn = jax.jit(compat.shard_map(local, mesh=m,
                                  in_specs=(specs, batch_specs(cfg, ("data",))),
                                  out_specs=specs, check_vma=False))
    with m:
        g = fn(params, batch0)
    for path, x in jax.tree_util.tree_flatten_with_path(g)[0]:
        res[f"grad{data}x{model}" + jax.tree_util.keystr(path)] = np.asarray(x)

# 4-step trajectories on the 2 x 2 mesh
for name, rt in (("plain", {}), ("zero1", dict(zero1=True)),
                 ("int8", dict(grad_comm_int8=True))):
    c = config(2, 2, **rt)
    m = make_mesh(c.parallel)
    params, opt = init_train_state(c, m, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
    step_fn, *_ = make_train_step(c, m, jax.eval_shape(lambda: params))
    traj = []
    with m:
        for s in range(4):
            b = {k: jnp.asarray(v)
                 for k, v in make_training_batch(cfg, 32, 8, s).items()}
            params, opt, loss, gn = step_fn(params, opt, b, jnp.int32(s))
            traj.append((float(loss), float(gn)))
    res["traj_" + name] = np.array(traj)

# sharded_xent at tp=2: value and gradient of the local logits
rng = np.random.default_rng(4)
logits = rng.standard_normal((2, 8, 128)).astype(np.float32) * 3
labels = rng.integers(0, 128, (2, 8)).astype(np.int32)
m = make_mesh(ParallelConfig(data=1, model=2))
ctx = AxisCtx(tp_axis="model", tp=2)
f = jax.jit(compat.shard_map(
    lambda x, l: jax.value_and_grad(lambda y: sharded_xent(y, l, ctx))(x),
    mesh=m, in_specs=(P(None, None, "model"), P()),
    out_specs=(P(), P(None, None, "model")), check_vma=False))
with m:
    v, g = f(jnp.asarray(logits), jnp.asarray(labels))
res["xent_logits"], res["xent_labels"] = logits, labels
res["xent_value"], res["xent_grad"] = np.asarray(v), np.asarray(g)
np.savez(out, **res)
print("CHILD_OK")
"""

PORT_TINY = ModelConfig(name="tiny", family="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=256, qk_norm=True)


def _grid_job(group, npz):
    """Every port variant on one rank of the 2 x 2 grid."""
    ref = dict(np.load(npz))
    whole = {k[4:]: v for k, v in ref.items() if k.startswith("init")}
    params = _from_keystr(whole)
    local = decoder.shard_params(params, group.rank, group.tp)
    out = {}

    def config(**rt):
        return Config(model=PORT_TINY, parallel=ParallelConfig(data=2,
                                                               model=2),
                      runtime=RuntimeConfig(mode="train", max_steps=20,
                                            warmup_steps=1, remat=False,
                                            **rt))

    # step 0's reduced gradients
    step = trainer.make_train_step(config(), group)
    batch0 = make_training_batch(PORT_TINY, 32, 8, 0)
    _, leaves, grads = step.grads(local, batch0)
    grads = trainer._grad_reduce(leaves, grads, step.ctx, False)
    out["grads"] = {leaf.name: [g.numpy() for g in gs]
                    for leaf, gs in zip(leaves, grads)}
    # trajectories
    for name, rt in (("plain", {}), ("zero1", dict(zero1=True)),
                     ("int8", dict(grad_comm_int8=True))):
        c = config(**rt)
        # fresh weights: shard_params hands replicated leaves back as they
        # are, and a run updates its params in place
        p = decoder.shard_params(_from_keystr(whole), group.rank, group.tp)
        p, opt = trainer.init_train_state(c, group=group, params=p)
        fn = trainer.make_train_step(c, group)
        traj = []
        for s in range(4):
            loss, gn = fn(p, opt, make_training_batch(PORT_TINY, 32, 8, s), s)
            traj.append((float(loss), float(gn)))
        out["traj_" + name] = np.array(traj)
        out["params_" + name] = [_leaf_arrays(leaf)
                                 for leaf in trainer.param_leaves(p)]
    # sharded_xent on this rank's vocab half
    x = torch.from_numpy(np.ascontiguousarray(
        ref["xent_logits"][..., group.rank * 64:(group.rank + 1) * 64])
    ).requires_grad_(True)
    v = sharded_xent(x, torch.from_numpy(ref["xent_labels"]), step.ctx)
    v.backward()
    out["xent"] = (float(v), x.grad.numpy())
    return out


def _from_keystr(flat):
    """Port params from a {keystr: array} dict of the reference's tree."""
    tree = {}
    for key, a in flat.items():
        parts = [p.strip("'") for p in key[1:-1].split("][")]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    tree["periods"] = tuple(tree["periods"][str(i)]
                            for i in range(len(tree["periods"])))
    return bridge.from_reference(tree)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grid") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [p for p in sys.path if p]))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _CHILD, path],
                         capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0 and "CHILD_OK" in res.stdout, \
        res.stderr[-3000:]
    port = mesh.spawn(_grid_job, 2, args=(path,), device="cpu", data=2,
                      timeout_s=600)
    return dict(np.load(path)), port


def test_grid_gradients_match_reference_and_scale_with_tp(grid):
    ref, port = grid
    names = [k[len("grad2x2"):] for k in ref if k.startswith("grad2x2")]
    assert len(names) == len(port[0]["grads"])
    for name in names:
        want, want_21 = ref["grad2x2" + name], ref["grad2x1" + name]
        # the reference's own tp scaling, leaf by leaf
        np.testing.assert_allclose(want, 2 * want_21, rtol=RTOL, atol=1e-6,
                                   err_msg=name)
        parts = [r["grads"][name] for r in port[:2]]     # dp rank 0
        stacked = [np.stack(p) if len(p) > 1 or p[0].ndim < want.ndim
                   else p[0] for p in parts]
        leaf_name = name.rsplit("['", 1)[-1].rstrip("']")
        parent = name.rsplit("['", 2)[-2].rstrip("']") if \
            name.count("['") > 1 else ""
        axis = decoder.shard_axis(leaf_name, parent, parts[0][0].ndim)
        if axis is None:
            got = stacked[0]
            np.testing.assert_array_equal(stacked[1], got)
        else:
            off = 1 if stacked[0].ndim > parts[0][0].ndim else 0
            got = np.concatenate(stacked, axis=axis + off)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6,
                                   err_msg=name)
        # every data rank holds the same mean
        for a, b in zip(port[0]["grads"][name], port[2]["grads"][name]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["plain", "zero1", "int8"])
def test_grid_trajectories_match_reference(grid, name):
    ref, port = grid
    for r in port:
        np.testing.assert_allclose(r["traj_" + name], ref["traj_" + name],
                                   rtol=RTOL)


def test_grid_zero1_equals_plain_adamw(grid):
    _, port = grid
    for r in port:
        for a, b in zip(r["params_zero1"], r["params_plain"]):
            np.testing.assert_allclose(a, b, atol=1e-4)


def test_grid_sharded_xent_tp2(grid):
    ref, port = grid
    for r in port:
        value, grad = r["xent"]
        np.testing.assert_allclose(value, float(ref["xent_value"]),
                                   rtol=1e-6)
    got = np.concatenate([port[0]["xent"][1], port[1]["xent"][1]], axis=-1)
    np.testing.assert_allclose(got, ref["xent_grad"], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_bf16(tmp_path):
    cfg = port_cfg(tiny_vlm())
    params = decoder.init_decoder_params(3, cfg, dtype=torch.bfloat16,
                                         device="cpu")
    checkpoint.save(str(tmp_path), {"params": params}, step=7)
    like = decoder.init_decoder_params(4, cfg, dtype=torch.bfloat16,
                                       device="cpu")
    got, step = checkpoint.restore(str(tmp_path), {"params": like})
    assert step == 7
    for a, b in zip(trainer.param_leaves(got), trainer.param_leaves(
            {"params": params})):
        assert a.name == b.name
        for x, y in zip(a.tensors, b.tensors):
            assert x.dtype == y.dtype        # bf16 matrices, fp32 norms
            assert torch.equal(x, y), a.name
    assert any(t.dtype == torch.bfloat16 for leaf in trainer.param_leaves(got)
               for t in leaf.tensors)


def test_checkpoint_restores_reference_save(tmp_path):
    ref_config, _ = _configs(tiny_moe())
    _, params, _ = _ref_state(ref_config)
    r_ckpt.save(str(tmp_path), {"params": params}, step=3)
    like = bridge.from_reference(_np_tree(jax.tree_util.tree_map(
        jnp.zeros_like, params)))
    got, step = checkpoint.restore(str(tmp_path), {"params": like})
    assert step == 3
    want = bridge.from_reference(_np_tree(params))
    for a, b in zip(trainer.param_leaves(got["params"]),
                    trainer.param_leaves(want)):
        for x, y in zip(a.tensors, b.tensors):
            assert torch.equal(x, y), a.name


def test_train_launcher_tiny(capsys, tmp_path):
    from repro_torch.launch import train
    assert train.main(["--arch", "qwen3-8b", "--preset", "tiny", "--steps",
                       "3", "--seq-len", "64", "--batch", "2", "--log-every",
                       "1", "--device", "cpu", "--ckpt",
                       str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert "arch=qwen3-8b preset=tiny" in out and "mesh=(1, 1)" in out
    assert out.count("step ") == 3
    assert os.path.exists(tmp_path / "ck" / "manifest.json")

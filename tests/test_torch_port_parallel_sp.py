"""PyTorch port, sequence parallelism against the JAX package (CPU).

Eight ranks over gloo, a (data 2, seq 4) mesh, one spawn for the whole file:
the port's ``make_sp_forward`` in gather and ring mode against the JAX
single-device ``FlowModel.apply``, and the SP train step's loss and gradients
(gather, and the ring's backward) against JAX ``value_and_grad`` on the same
times and the same assembled noise, which are the JAX SP step's own
split-then-fold streams injected into the port's step.  Tolerances are the
JAX package's own (tests/test_sequence_parallel.py): forward rtol 2e-5 and
atol 2e-6, loss rtol 1e-5, gradients rtol 2e-4 (absolute floor:
``assert_grads_close``).  Also
``host_entry_range`` against the JAX version and the JAX package's
refusals.  No JAX ``shard_map`` runs here: the JAX package's own tests hold
its sharded paths against single-device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.models.flow_model import FlowModel as JFlowModel
from superresolutionhep_tpu.parallel.distributed import host_entry_range as jhost_entry_range
from superresolutionhep_tpu_torch.parallel.distributed import host_entry_range
from superresolutionhep_tpu_torch.parallel.launch import run_ranks
from superresolutionhep_tpu_torch.tools.convert import params_from_jax

from _torch_parallel_ranks import sp_rank
from test_flow_model import make_batch, small_flow_config

torch.set_num_threads(1)

SIGMA = 1e-5
SHAPE = {"data": 2, "seq": 4}
RANK_TIMEOUT_S = 120


def one_layer(cfg):
    return dict(cfg, transformer=dict(cfg["transformer"], num_transformer_layers=1))


def flow_inputs():
    """The JAX package's SP test inputs: B=4, N=32, ragged lengths."""
    batch = {k: np.asarray(v) for k, v in make_batch(B=4, N=32, lengths=(32, 20, 9, 27), seed=5).items()}
    batch["target"] = np.random.default_rng(9).normal(size=(4, 32, 1)).astype(np.float32)
    noisy = np.random.default_rng(6).normal(size=(4, 32, 1)).astype(np.float32)
    t = np.asarray([0.2, 0.5, 0.7, 0.9], np.float32)
    return batch, noisy, t


def jax_init(cfg, batch, noisy, t):
    """Randomly initialised JAX FlowModel params (one jitted init), numpy;
    and the one-layer model with the same params but for its second layer."""
    model = JFlowModel(config=cfg, attn_impl="xla")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jb, jnp.asarray(noisy), jnp.asarray(t))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params1 = dict(params, transformer={k: v for k, v in params["transformer"].items() if k != "layers_1"})
    return model, params, JFlowModel(config=one_layer(cfg), attn_impl="xla"), params1


def jax_streams(target, rng, n_data, n_seq=None):
    """The JAX parallel train steps' draws, assembled over the global batch:
    t per data shard (fold d, split), x0 per shard — over (data, seq) with a
    further fold s (parallel/sp.py), over data alone with ``n_seq=None``
    (parallel/tp.py)."""
    B, N = target.shape[:2]
    Bl = B // n_data
    x0, ts = np.zeros_like(target), []
    for d in range(n_data):
        key_t, key_x0 = jax.random.split(jax.random.fold_in(rng, d))
        ts.append(np.asarray(jax.random.uniform(key_t, (Bl,), jnp.float32)))
        rows = slice(d * Bl, (d + 1) * Bl)
        if n_seq is None:
            x0[rows] = np.asarray(jax.random.normal(jax.random.split(key_x0)[0], (Bl, N, 1), jnp.float32))
            continue
        Nl = N // n_seq
        for s in range(n_seq):
            k_noise = jax.random.split(jax.random.fold_in(key_x0, s))[0]
            x0[rows, s * Nl:(s + 1) * Nl] = np.asarray(jax.random.normal(k_noise, (Bl, Nl, 1), jnp.float32))
    return np.concatenate(ts), x0


def jax_loss_and_grads(model, cfg):
    """``fn(params, batch, t, x0)``: the single-device flow-matching loss on
    the given draws and its JAX ``value_and_grad`` (jitted once), gradients
    in the port's ``state_dict`` layout."""

    @jax.jit
    def value_and_grad(params, jb, t, x0):
        x1, t_b = jb["target"], t[:, None, None]
        xt = (1.0 - (1.0 - SIGMA) * t_b) * x0 + t_b * x1
        ut = x1 - (1.0 - SIGMA) * x0

        def loss_fn(p):
            vt = model.apply({"params": p}, jb, xt, t)
            m = jb["q_mask"][..., None].astype(vt.dtype)
            return ((vt - ut) ** 2 * m).sum() / jnp.maximum(m.sum(), 1.0)

        return jax.value_and_grad(loss_fn)(params)

    def fn(params, batch, t, x0):
        loss, grads = value_and_grad(params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(t),
                                     jnp.asarray(x0))
        return float(loss), port_params(jax.tree_util.tree_map(np.asarray, grads), cfg)

    return fn


def port_params(params, cfg):
    return {k[4:]: v.numpy() for k, v in params_from_jax(params, cfg).items()}


def assemble(results, key, shape, like):
    """The global (B, N, ...) array from each rank's block by its coords."""
    out = np.zeros_like(like)
    B, N = like.shape[:2]
    Bl, Nl = B // shape.get("data", 1), N // shape.get("seq", 1)
    for r in results:
        d, s = r["coords"].get("data", 0), r["coords"].get("seq", 0)
        out[d * Bl:(d + 1) * Bl, s * Nl:(s + 1) * Nl] = r[key]
    return out


def assert_grads_close(got, want):
    """Each element within the JAX package's rtol 2e-4, with an absolute
    floor of 1e-6 or 1e-5 of the leaf's max, whichever is larger: torch and
    XLA sum in other orders (the port's single-device train test allows 1e-4
    of the max)."""
    assert set(got) == set(want)
    for k in want:
        atol = max(1e-6, 1e-5 * float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=atol, err_msg=f"grad mismatch at {k}")


@pytest.fixture(scope="module")
def setup():
    cfg = small_flow_config("DiT")
    cfg1 = one_layer(cfg)
    batch, noisy, t = flow_inputs()
    model, params, model1, params1 = jax_init(cfg, batch, noisy, t)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = np.asarray(jax.jit(model.apply)({"params": params}, jb, jnp.asarray(noisy), jnp.asarray(t)))
    t_step, x0 = jax_streams(batch["target"], jax.random.PRNGKey(3), SHAPE["data"], SHAPE["seq"])
    ref_loss, ref_grads = jax_loss_and_grads(model1, cfg1)(params1, batch, t_step, x0)
    return dict(cfg=cfg, cfg1=cfg1, batch=batch, noisy=noisy, t=t, ref=ref, params=port_params(params, cfg),
                params1=port_params(params1, cfg1), t_step=t_step, x0=x0, ref_loss=ref_loss, ref_grads=ref_grads)


@pytest.fixture(scope="module")
def ranks(setup):
    s = setup
    inputs = dict(s["batch"], noisy=s["noisy"], t=s["t"], t_step=s["t_step"], x0=s["x0"])
    return run_ranks(sp_rank, 8, (SHAPE, s["cfg"], s["params"], s["cfg1"], s["params1"], inputs),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)


@pytest.mark.parametrize("mode", ["gather", "ring"])
def test_sp_forward_matches_jax(setup, ranks, mode):
    out = assemble(ranks, f"fwd_{mode}", SHAPE, setup["ref"])
    np.testing.assert_allclose(out, setup["ref"], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("mode", ["gather", "ring"])
def test_sp_train_step_matches_jax(setup, ranks, mode):
    """Loss and every gradient against single-device JAX on the JAX SP
    step's own draws; every rank holds the same (summed) gradients.  The
    ring case is the ring's backward: the rotation's cotangents sent back."""
    for r in ranks:
        np.testing.assert_allclose(float(r[f"loss_{mode}"]), setup["ref_loss"], rtol=1e-5)
        assert_grads_close(r[f"grads_{mode}"], setup["ref_grads"])


def test_host_entry_range_matches_jax():
    for n_events, n_proc in ((103, 8), (5, 8), (64, 4), (1, 1)):
        ranges = [host_entry_range(n_events, pid, n_proc) for pid in range(n_proc)]
        assert ranges == [jhost_entry_range(n_events, pid, n_proc) for pid in range(n_proc)]
    assert host_entry_range(10) == (0, 10)  # no process group: the whole range


def test_refusals(ranks):
    refused = ranks[0]["refusals"]
    assert refused and all(refused.values()), {k: v for k, v in refused.items() if not v}

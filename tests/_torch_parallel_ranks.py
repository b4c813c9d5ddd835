"""Rank bodies of the port's parallel tests (tests/test_torch_port_parallel_*.py).

Each spawned rank imports this module by name, so it imports torch and the
port only, never JAX: a rank starts in a few seconds.  Inputs arrive as numpy
arrays and results go back as numpy arrays (parallel/launch.py).
"""

import numpy as np
import torch

from superresolutionhep_tpu_torch.parallel.mesh import Mesh, shard_batch


def _tensors(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _raises(fn, exc):
    try:
        fn()
    except exc:
        return True
    return False


def refusals(mesh):
    """The JAX package's refusals, each True where the port refuses."""
    from superresolutionhep_tpu_torch.models.attention import MultiheadAttention
    from superresolutionhep_tpu_torch.models.dense import Dense
    from superresolutionhep_tpu_torch.models.dit import DiTLayer

    sp, tp = mesh.group("seq"), mesh.group("seq")  # any group of 4 ranks serves for the checks
    x = torch.zeros(1, 4, 8)
    q_valid = torch.ones(1, 4, dtype=torch.bool)
    ring = MultiheadAttention(8, 2, sp_group=sp, sp_mode="ring")
    gather = MultiheadAttention(8, 2, sp_group=sp)
    fused_ln = (torch.ones(1, 8), torch.zeros(1, 8))
    return {
        "tp_without_out_proj": _raises(lambda: MultiheadAttention(8, 2, out_proj=False, tp_group=tp), ValueError),
        "tp_with_edges": _raises(lambda: MultiheadAttention(8, 2, edge_embed_dim=4, tp_group=tp), ValueError),
        "tp_with_dropout": _raises(lambda: MultiheadAttention(8, 2, dropout=0.1, tp_group=tp), ValueError),
        "ring_with_bias": _raises(lambda: ring(x, q_valid=q_valid, attn_bias=torch.zeros(1, 4, 4, 2)),
                                  NotImplementedError),
        "ring_with_attn_valid": _raises(lambda: ring(x, attn_valid=torch.ones(1, 4, 4, dtype=torch.bool)),
                                        NotImplementedError),
        "sp_with_segments": _raises(lambda: gather(x, segment_ids=torch.zeros(1, 4, dtype=torch.long)),
                                    NotImplementedError),
        "fused_ln_with_sp": _raises(lambda: gather(x, q_valid=q_valid, fused_ln=fused_ln), ValueError),
        "fused_ln_with_tp": _raises(
            lambda: MultiheadAttention(8, 2, q_dim=16, tp_group=tp)(x, q_valid=q_valid, fused_ln=fused_ln), ValueError),
        "dense_tp_two_hidden": _raises(lambda: Dense(8, 8, hidden_layers=(8, 8), tp_group=tp), ValueError),
        "dense_tp_norm_final": _raises(
            lambda: Dense(8, 8, hidden_layers=(8,), norm_layer="LayerNorm", norm_final_layer=True, tp_group=tp),
            ValueError),
        "dit_tp_heads": _raises(lambda: DiTLayer(8, 2, 4, tp_group=tp), ValueError),
        "dit_tp_hidden": _raises(lambda: DiTLayer(16, 4, 4, {"hidden_layers": [6]}, tp_group=tp), ValueError),
    }


def sp_rank(rank, world_size, shape, cfg, params, cfg1, params1, inputs):
    """dp x seq: the forward in gather and ring mode on ``cfg``, the train
    step in both modes on the one-layer ``cfg1`` (inputs: the model's keys,
    ``noisy`` and ``t`` for the forward, ``target``, ``t_step`` and ``x0``
    for the step)."""
    from superresolutionhep_tpu_torch.parallel.sp import make_sp_forward, make_sp_train_step

    torch.set_num_threads(1)
    mesh = Mesh(shape)
    local = _tensors(shard_batch(inputs, mesh, cells=True))
    params, params1 = _tensors(params), _tensors(params1)
    out = {"coords": dict(zip(mesh.names, mesh.coords))}
    for mode in ("gather", "ring"):
        _, fwd = make_sp_forward(cfg, mesh, sp_mode=mode, device="cpu")
        with torch.no_grad():
            out[f"fwd_{mode}"] = fwd(params, local, local["noisy"], local["t"])
        _, step = make_sp_train_step(cfg1, mesh, float(cfg1["sigma_min"]), sp_mode=mode, device="cpu")
        out[f"loss_{mode}"], out[f"grads_{mode}"] = step(params1, local, local["t_step"], local["x0"])
    if rank == 0:
        out["refusals"] = refusals(mesh)
    return out


TP_MESHES = {  # name -> (shape, world size of its run)
    "dp2_tp2": ({"data": 2, "model": 2}, 4),
    "dp1_sp2_tp2": ({"data": 1, "seq": 2, "model": 2}, 4),
    "dp1_tp2": ({"data": 1, "model": 2}, 2),
}


def tp_rank(rank, world_size, cfg, params, cfg1, params1, inputs):
    """The meshes of ``TP_MESHES`` that span ``world_size`` ranks: on each
    the forward on ``cfg`` and the train step on ``cfg1`` (inputs as for
    ``sp_rank``, but a ``t_step_<mesh>`` and ``x0_<mesh>`` for each mesh's
    step); on two ranks also Megatron's f and g."""
    from superresolutionhep_tpu_torch.parallel.tp import make_sp_tp_forward, make_tp_forward, make_tp_train_step

    torch.set_num_threads(1)
    params, params1 = _tensors(params), _tensors(params1)
    out = {}
    for name, (shape, n) in TP_MESHES.items():
        if n != world_size:
            continue
        mesh = Mesh(shape)
        has_seq = mesh.has("seq")
        local = _tensors(shard_batch(inputs, mesh, cells=has_seq))
        res = out[name] = {"coords": dict(zip(mesh.names, mesh.coords))}
        if has_seq:
            _, fwd = make_sp_tp_forward(cfg, mesh, device="cpu")
        else:
            _, fwd = make_tp_forward(cfg, mesh, device="cpu")
        with torch.no_grad():
            res["fwd"] = fwd(params, local, local["noisy"], local["t"])
        _, step = make_tp_train_step(cfg1, mesh, float(cfg1["sigma_min"]), device="cpu")
        res["loss"], res["grads"] = step(params1, local, local[f"t_step_{name}"], local[f"x0_{name}"])
        if world_size == 2:
            res["f_g"] = f_g_grads(mesh.index("model"), mesh.group("model"))
    return out


def f_g_grads(rank, group):
    """Gradients through Megatron's f and g at two ranks: x the same on
    both, a rank-dependent factor a = rank + 2."""
    from superresolutionhep_tpu_torch.ops.tp import tp_allreduce, tp_block_input

    a = float(rank + 2)
    x = torch.arange(1.0, 4.0, requires_grad=True)
    (gx_f,) = torch.autograd.grad((tp_block_input(x, group) * a).sum(), x)
    z = tp_allreduce(x * a, group)
    (gx_g,) = torch.autograd.grad((z * torch.tensor([1.0, 2.0, 3.0])).sum(), x)
    return {"f_grad": gx_f, "g_value": z.detach(), "g_grad": gx_g}


# ---------------------------------------------------------------------------
# data parallelism of the trainers
# ---------------------------------------------------------------------------


def sr_dataset(config_mv, n=8, seed=3):
    """Synthetic events of 108 and 216 high-resolution cells."""
    from superresolutionhep_tpu_torch.data.sr_dataset import SupResEvents
    from superresolutionhep_tpu_torch.data.synthetic import GeneratorConfig, generate_events

    trees = generate_events(n, seed=seed, config=GeneratorConfig(min_particles=1, max_particles=2, window_lr_cells=1))
    return SupResEvents.from_trees(trees["Low_Tree"], trees["High_Tree"], config_mv)


def sr_host_batch(config_mv):
    """A (4, 256) batch whose first two rows hold 216 cells each and whose
    last two hold 108 and a filler row: the two data shards' cell counts
    differ (432 against 108)."""
    from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS, collate

    ds = sr_dataset(config_mv)
    big = [i for i, c in enumerate(ds.cell_count_high) if c == 216][:2]
    small = [i for i, c in enumerate(ds.cell_count_high) if c == 108][:1]
    hb = collate([ds.get_event(i) for i in big + small] + [None], 256)
    return {k: hb[k] for k in MODEL_BATCH_KEYS}


def recorded_grads(trainer):
    """Wrap the trainer's optimizer step to keep the gradients it is handed."""
    seen = []
    step = trainer.opt.step

    def keep(grads, lr):
        seen.append([g.detach().clone() for g in grads])
        return step(grads, lr)

    trainer.opt.step = keep
    return seen


def recorded_losses(trainer):
    """Wrap ``train_step`` to keep each step's loss and gradient norm."""
    losses = []
    step = trainer.train_step

    def keep(*args, **kw):
        stats = step(*args, **kw)
        losses.append(torch.stack([stats["loss"], stats["grad_norm"]]))
        return stats

    trainer.train_step = keep
    return losses


def sr_step(config_mv, config_t, batch, run_dir, mesh=None, lr=1e-3):
    """One ``SRTrainer`` step on ``batch`` (this rank's rows under ``mesh``):
    its statistics, the gradients the optimizer was handed, the parameters
    after the update."""
    from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

    tr = SRTrainer(config_mv, config_t, run_dir=run_dir, seed=0, device="cpu", mesh=mesh)
    seen = recorded_grads(tr)
    stats = tr.train_step(_tensors(batch), lr=lr)
    names = [n for n, _ in tr.model.named_parameters()]
    return {"stats": stats, "grads": dict(zip(names, seen[0])), "params": tr.model.state_dict()}


def pf_step(config_mv, config_t, batch, run_dir, mesh=None, lr=1e-3):
    """One ``PFTrainer`` step, as ``sr_step``."""
    from superresolutionhep_tpu_torch.train.pf_trainer import PFTrainer

    tr = PFTrainer(config_mv, config_t, run_dir=run_dir, seed=0, device="cpu", mesh=mesh)
    seen = recorded_grads(tr)
    logs = tr.train_step(_tensors(batch), lr=lr)
    names = [n for n, _ in tr.model.named_parameters()]
    return {"logs": logs, "grads": dict(zip(names, seen[0])), "params": tr.model.state_dict()}


def sr_fit(config_mv, config_t, run_dir, mesh=None):
    """``fit`` for ``config_t``'s epochs, then a second trainer resumes from
    the last checkpoint for one epoch more: the per-step losses of both, the
    parameters after each."""
    from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

    ds = sr_dataset(config_mv)
    tr = SRTrainer(config_mv, config_t, run_dir=run_dir, seed=0, device="cpu", mesh=mesh)
    losses = recorded_losses(tr)
    tr.fit(ds)
    if mesh is not None:
        torch.distributed.barrier()  # rank 0 has written the checkpoint
    tr2 = SRTrainer(config_mv, dict(config_t, num_epochs=int(config_t["num_epochs"]) + 1), run_dir=run_dir, seed=1,
                    device="cpu", mesh=mesh)
    losses2 = recorded_losses(tr2)
    tr2.fit(ds, resume=True)
    return {"losses": losses, "params": tr.model.state_dict(), "losses_resumed": losses2,
            "params_resumed": tr2.model.state_dict(), "epoch_resumed": tr2.epoch, "opt_count": tr2.opt.count}


def fit_one_epoch(kind, config_mv, config_t, data, run_dir, mesh=None):
    """One ``fit`` epoch of the SR (``data``: the ``sr_dataset`` config) or
    PF trainer (``data``: the trees of a ``PflowEvents``), no validation:
    the per-step losses and gradient norms, the parameters after it, and
    for each parameter the least magnitude its gradient took over the steps
    (elementwise)."""
    if kind == "sr":
        from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer as Trainer

        ds = sr_dataset(config_mv)
    else:
        from superresolutionhep_tpu_torch.data.pf_dataset import PflowEvents
        from superresolutionhep_tpu_torch.train.pf_trainer import PFTrainer as Trainer

        ds = PflowEvents.from_trees(data, config_mv, energy_threshold=1.0, load_incidence=True)
    tr = Trainer(config_mv, dict(config_t, num_epochs=1), run_dir=run_dir, seed=0, device="cpu", mesh=mesh)
    losses, seen = recorded_losses(tr), recorded_grads(tr)
    tr.fit(ds)
    names = [n for n, _ in tr.model.named_parameters()]
    least = [torch.stack([g[i].abs() for g in seen]).amin(0) for i in range(len(names))]
    return {"losses": losses, "params": tr.model.state_dict(), "least_grad": dict(zip(names, least))}


def dp_rank(rank, world_size, sr_cfgs, sr_batch, pf_cfgs, pf_batch, pf_trees, run_dir):
    """Two data-parallel ranks: one SR step, one PF step (each on the rank's
    rows of the global batch), an SR ``fit`` with gradient accumulation and
    clipping resumed on both ranks, a packed SR and a PF ``fit`` epoch (each
    rank collating its own rows), and the trainers' refusals."""
    import os

    from superresolutionhep_tpu_torch.parallel.mesh import make_mesh
    from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

    torch.set_num_threads(1)
    mesh = make_mesh(data=world_size)
    out = {
        "sr_step": sr_step(*sr_cfgs, shard_batch(sr_batch, mesh), os.path.join(run_dir, "sr_step"), mesh),
        "pf_step": pf_step(*pf_cfgs, shard_batch(pf_batch, mesh), os.path.join(run_dir, "pf_step"), mesh),
        "fit": sr_fit(sr_cfgs[0], dict(sr_cfgs[1], grad_accum_steps=2, grad_clip_norm=0.05, bucket_quantum=256),
                      os.path.join(run_dir, "fit"), mesh),
        "packed_fit": fit_one_epoch("sr", sr_cfgs[0], dict(sr_cfgs[1], packed=True, pack_s=512, pack_rows=2), None,
                                    os.path.join(run_dir, "packed_fit"), mesh),
        "pf_fit": fit_one_epoch("pf", *pf_cfgs, pf_trees, os.path.join(run_dir, "pf_fit"), mesh),
    }
    seq_mesh = Mesh({"data": 1, "seq": world_size})
    out["refuses_seq_mesh"] = _raises(
        lambda: SRTrainer(*sr_cfgs, run_dir=os.path.join(run_dir, "x"), device="cpu", mesh=seq_mesh), ValueError)
    return out


# ---------------------------------------------------------------------------
# stage 2 (SAPF): sequence and tensor parallelism
# ---------------------------------------------------------------------------


def pf_sp_rank(rank, world_size, shape, config_pf, var_cfg, params, config_t, batch):
    """dp x seq on the SAPF: the forward and the train step in gather and in
    ring mode, on this rank's rows and cell block."""
    from superresolutionhep_tpu_torch.parallel.sp import make_pf_sp_forward, make_pf_sp_train_step
    from superresolutionhep_tpu_torch.transforms import build_var_transforms

    torch.set_num_threads(1)
    mesh = Mesh(shape)
    transforms = build_var_transforms(var_cfg)
    local = _tensors(shard_batch(batch, mesh, cells=True, pf=True))
    params = _tensors(params)
    out = {"coords": dict(zip(mesh.names, mesh.coords))}
    for mode in ("gather", "ring"):
        _, fwd = make_pf_sp_forward(config_pf, transforms, mesh, sp_mode=mode, device="cpu")
        with torch.no_grad():
            out[f"fwd_{mode}"] = fwd(params, local)
        _, step = make_pf_sp_train_step(config_pf, transforms, mesh, config_t, sp_mode=mode, device="cpu")
        out[f"loss_{mode}"], out[f"grads_{mode}"] = step(params, local)
    return out


PF_TP_MESHES = {"dp2_tp2": {"data": 2, "model": 2}, "dp1_tp4": {"data": 1, "model": 4}}


def pf_tp_rank(rank, world_size, config_pf, var_cfg, params, config_t, batch):
    """dp x tp on the SAPF, on each mesh of ``PF_TP_MESHES``: the forward and
    the train step on this rank's rows."""
    from superresolutionhep_tpu_torch.parallel.tp import make_pf_tp_forward, make_pf_tp_train_step
    from superresolutionhep_tpu_torch.transforms import build_var_transforms

    torch.set_num_threads(1)
    transforms = build_var_transforms(var_cfg)
    params = _tensors(params)
    out = {}
    for name, shape in PF_TP_MESHES.items():
        mesh = Mesh(shape)
        local = _tensors(shard_batch(batch, mesh))
        res = out[name] = {"coords": dict(zip(mesh.names, mesh.coords))}
        _, fwd = make_pf_tp_forward(config_pf, transforms, mesh, device="cpu")
        with torch.no_grad():
            res["fwd"] = fwd(params, local)
        _, step = make_pf_tp_train_step(config_pf, transforms, mesh, config_t, device="cpu")
        res["loss"], res["grads"] = step(params, local)
    return out


# ---------------------------------------------------------------------------
# validation split over data-parallel ranks
# ---------------------------------------------------------------------------


def evaluations(sr_cfgs, pf_cfgs, pf_trees, run_dir, mesh=None):
    """The trainers' ``evaluate`` on five SR events of 108 and 216 cells
    (batches of four: the second holds one event and three fillers, so that
    at two ranks one rank's rows are fillers alone) with dopri5, then with a
    fixed-step sampler and the live residual plots, and on ten PF
    events (random slots) with the plots; each trainer's next draw from its
    generator afterwards, and the figures this rank wrote."""
    import os

    from superresolutionhep_tpu_torch.data.pf_dataset import PflowEvents
    from superresolutionhep_tpu_torch.train.pf_trainer import PFTrainer
    from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

    import matplotlib

    matplotlib.use("Agg")
    sr_ds = sr_dataset(sr_cfgs[0], n=5)
    sr = SRTrainer(*sr_cfgs, run_dir=os.path.join(run_dir, "sr"), seed=0, device="cpu", mesh=mesh)
    out = {"sr_dopri5": sr.evaluate(sr_ds, n_steps=3)}
    sr.config_t = dict(sr.config_t, val_ode_method="midpoint")
    out["sr_plots"] = sr.evaluate(sr_ds, n_steps=3, make_plots=True)
    out["sr_next_draw"] = torch.randn(4, generator=sr.generator)
    pf_ds = PflowEvents.from_trees(pf_trees, pf_cfgs[0], energy_threshold=1.0, load_incidence=True)
    pf = PFTrainer(*pf_cfgs, run_dir=os.path.join(run_dir, "pf"), seed=0, device="cpu", mesh=mesh)
    out["pf"] = pf.evaluate(pf_ds, make_plots=True)
    out["pf_next_draw"] = torch.randn(4, generator=pf.generator)
    out["figures"] = sorted(f for part in ("sr", "pf") if os.path.isdir(os.path.join(run_dir, part, "figures"))
                            for f in os.listdir(os.path.join(run_dir, part, "figures")))
    return out


def val_rank(rank, world_size, sr_cfgs, pf_cfgs, pf_trees, run_dir):
    """``evaluations`` on this rank's rows of every validation batch (each
    rank its own run directory)."""
    import os

    from superresolutionhep_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    return evaluations(sr_cfgs, pf_cfgs, pf_trees, os.path.join(run_dir, f"rank{rank}"),
                       make_mesh(data=world_size))

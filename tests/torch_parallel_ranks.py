"""What the ranks of tests/test_torch_parallel.py and
tests/test_torch_table_sharded.py run: module-level functions (spawned
processes import them by name) of the port alone, each run as
fn(rank, world, device, *args) under hashnerf_torch.parallel.mesh.launch,
or in the test's own process as one rank of one (world 1, no process
group). Results are numpy arrays."""
import dataclasses
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.txt")
# the small widths of these tests: synthetic_smoke.txt's table and MLPs,
# 64 rays of 8 + 8 samples, sigma noise on (so that its draws are tested)
SMALL = ["--N_rand", "64", "--N_samples", "8", "--N_importance", "8", "--raw_noise_std", "1.0",
         "--device", "cpu"]
# OmniNeRF's model, small: positional NeRFGradient, Adam, depth and
# gradient supervision (st3d's column pool)
OMNI = ["--i_embed", "0", "--i_embed_views", "0", "--use_depth", "--use_gradient", "--netdepth",
        "2", "--netwidth", "32"]
# the flagship's global culling (block 8, adaptive updates, a keep
# schedule) in float32 at these widths: warmup 2 steps, an update every 2;
# per point (block 1); and the tpu-fast preset itself (bf16 MLP operands)
GLOBAL_POINT = ["--n_levels", "4", "--n_features_per_level", "8", "--packed_layout",
                "--share_fine", "--aabb_clip", "--use_occupancy", "--occ_keep_fraction", "0.25",
                "--occ_keep_coarse", "0.5", "--occ_keep_schedule", "0:0.5,4:0.25",
                "--occ_adaptive_update", "--occ_warmup", "2", "--occ_update_every", "2"]
GLOBAL = GLOBAL_POINT + ["--occ_block", "8"]
TPU_FAST = ["--preset", "tpu-fast", "--occ_warmup", "2", "--occ_update_every", "2"]
PER_RAY = ["--n_levels", "4", "--n_features_per_level", "8", "--packed_layout", "--share_fine",
           "--compute_dtype", "bfloat16", "--aabb_clip", "--use_occupancy", "--occ_per_ray",
           "--occ_keep_fraction", "0.25", "--occ_keep_coarse", "0.5", "--occ_warmup", "2",
           "--occ_update_every", "2"]


def small_args(flags=(), world=1, settings=None):
    """synthetic_smoke.txt at SMALL widths with flags; or, given settings
    (the JAX test's args as a dict), the parser's defaults with those."""
    from hashnerf_torch.train.config import config_parser, parse_args

    n = ["--num_devices", str(world)] if world > 1 else []
    if settings is None:
        return parse_args(["--config", SMOKE, *SMALL, *flags, *n])
    args = config_parser().parse_args(["--device", "cpu", *n])
    for k, v in settings.items():
        setattr(args, k, v)
    return args


def jax_scene():
    """The scene of the JAX comparisons (make_synthetic_scene of both
    packages gives the same arrays)."""
    from hashnerf_torch.data.synthetic import make_synthetic_scene

    return make_synthetic_scene(H=24, W=24, n_train=3, n_test=1)


def dp_jax_run(rank, world, device, settings, jax_state, batch, jax_grads, occ_grid=None):
    """One step of make_sharded_train_step (world 1: in this process) from
    the JAX state (numpy
    (table, coarse, fine)) on the global batch, without TV, culled by
    occ_grid (numpy) when given. Returns the
    metrics, each parameter's summed gradient beside JAX's (in the port's
    layout) and the state after the step."""
    from hashnerf_torch.convert import jax_pairs, load_jax_state
    from hashnerf_torch.parallel.mesh import Layout, make_mesh
    from hashnerf_torch.parallel.train_sharded import make_sharded_train_step
    from hashnerf_torch.train.driver import Trainer, make_loss_fn

    args = small_args(settings=settings)
    # world 1: this process alone, no process group (nothing to sum)
    layout = make_mesh(world) if world > 1 else Layout(1, 1, 0, 0, 0, None, None)
    sc = jax_scene()
    t = Trainer(args, sc, device=device)
    load_jax_state(t.state, *jax_state)
    loss_fn = make_loss_fn(args, t.render_cfg, t.bbox, t.model_cfg, with_tv=False, hwf=sc.hwf)
    step = make_sharded_train_step(layout, loss_fn, t.optimizer, t.render_cfg)
    grid = None if occ_grid is None else torch.from_numpy(occ_grid)
    m = step(t.state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0.0, occ_grid=grid)
    grads = [(to_np(p.grad), a) for p, a in jax_pairs(t.state, *jax_grads)]
    return {"loss": float(m["loss"]), "psnr": float(m["psnr"]), "grads": grads,
            "state": [(to_np(p), a) for p, a in jax_pairs(t.state, *jax_state)]}


def scene(ndc=False):
    from hashnerf_torch.data.synthetic import make_synthetic_scene

    sc = make_synthetic_scene(H=16, W=16, n_train=2, n_test=1)
    if ndc:
        # the forward-facing path's NDC warp and ray pool on a small scene
        sc = dataclasses.replace(sc, ndc=True, near=0.0, far=1.0)
    return sc


def scale_tables(state):
    """Tables of U(-1, 1), as after some training (tests/test_torch_train.py
    says why the init scale makes RAdam's first moving steps chaotic)."""
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in state.table_parameters():
            layout = getattr(state, "layout", None)
            if layout is None:
                p.copy_(torch.rand(p.shape, generator=g) * 2 - 1)
                continue
            # a level shard: its levels of the whole table's draw
            whole = torch.rand((state.cfg.hash_grid.n_levels, *p.shape[1:]), generator=g)
            start = layout.model_index * p.shape[0]
            p.copy_(whole[start:start + p.shape[0]] * 2 - 1)


def to_np(t):
    return t.detach().cpu().float().numpy().copy()


def state_np(state):
    return {k: to_np(v) for k, v in state.state_dict().items()}


def trainer_run(rank, world, device, flags, n_steps, mode="step", seed=3, next_seed=None):
    """n_steps of a Trainer from one seed and U(-1, 1) tables: eager steps
    on sample_batch ("step"), run_steps blocks of 2 ("blocks"), or blocks
    on the ray pool of an NDC scene ("pool"), or blocks on a pool of st3d's
    columns with depth and gradient targets ("columns"). Returns each
    step's (or
    block's last) loss and psnr, the final state and the occupancy grid;
    with next_seed, also the loss of one more step after the generator is
    seeded with it."""
    from hashnerf_torch.train.driver import Trainer

    if mode == "columns":
        from hashnerf_torch.data.st3d import st3d_scene

        sc = st3d_scene(16, 32)
    else:
        sc = scene(ndc=mode == "pool")
    t = Trainer(small_args(flags, world), sc, device=device, seed=seed)
    scale_tables(t.state)
    losses = []
    if mode == "step":
        for _ in range(n_steps):
            m = t.step(t.sample_batch(False))
            losses.append((float(m["loss"]), float(m["psnr"])))
    elif mode == "blocks":
        for _ in range(n_steps // 2):
            m = t.run_steps(2, block_size=2)
            losses.append((float(m["loss"]), float(m["psnr"])))
    else:
        if mode == "columns":
            rng = np.random.default_rng(0)
            d = rng.normal(size=(4096, 3))
            pool = t.build_column_pool({
                "rays_o": rng.normal(scale=0.1, size=(4096, 3)),
                "rays_d": d / np.linalg.norm(d, axis=-1, keepdims=True),
                "target": rng.uniform(size=(4096, 3)), "target_depth": rng.uniform(size=4096),
                "target_grad": rng.normal(size=(4096, 3))})
        else:
            pool = t.build_ray_pool()
        for k in range(n_steps // 2):
            m = t.run_steps(2, block_size=2, pool=pool, offset=k * 2 * t.args.N_rand)
            losses.append((float(m["loss"]), float(m["psnr"])))
    out = {"losses": losses, "state": state_np(t.state), "global_step": t.global_step,
           "occ": None if t.occ_grid is None else to_np(t.occ_grid), "keeps": t.last_occ_keep}
    if next_seed is not None:
        out["next_loss"] = next_step_loss(t, next_seed)
    return out


def next_step_loss(t, seed):
    """The loss of one more step of trainer t, its generator seeded first."""
    t.generator.manual_seed(seed)
    return float(t.step(t.sample_batch(False))["loss"])


# the JAX comparisons' args, on both sides (deterministic rendering)
JAX_SETTINGS = dict(N_rand=64, N_samples=8, N_importance=8, lrate=0.01, lrate_decay=10,
                    use_viewdirs=True, finest_res=64, log2_hashmap_size=10, white_bkgd=True,
                    no_batching=True, perturb=0.0, raw_noise_std=0.0)

# deterministic rendering and no TV: the ZeRO-1 and table-sharded steps'
# comparisons with the one-device step (ZeRO-1 divides the sparsity's
# per-ray sum by N with everything else, as JAX's does: weight 0 here)
DET = ["--perturb", "0", "--raw_noise_std", "0", "--tv-loss-weight", "0"]


def zero_run(rank, world, device, flags, n_steps, wire, seed=3, jax_state=None, settings=None,
             batch=None, save=None):
    """n_steps of the ZeRO-1 step (wire "float32" or "bfloat16") on one
    fixed batch (sample_image's, or batch) from U(-1, 1) tables (or from
    jax_state, numpy (table, coarse, fine), with the JAX test's settings).
    Returns the losses, this rank's master chunks and first moments, the
    shapes of its moments and parameters and the batch. save: a
    checkpoint path, written after the steps (save_dp_zero), then restored
    into a fresh trainer's chunks (restore_dp_zero): whether they and
    their moments came back equal."""
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.parallel.mesh import make_mesh
    from hashnerf_torch.parallel.train_sharded import (
        init_dp_zero, make_dp_zero_train_step, rank_generator, restore_dp_zero, save_dp_zero,
    )
    from hashnerf_torch.train.driver import Trainer, make_loss_fn

    args = small_args([*DET, *flags], settings=settings)
    sc = scene() if settings is None else jax_scene()
    t = Trainer(args, sc, device=device, seed=seed)
    if jax_state is None:
        scale_tables(t.state)
    else:
        load_jax_state(t.state, *jax_state)
    if batch is None:
        batch = t.sample_image(0, args.N_rand, False)
    else:
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    layout = make_mesh(world)
    loss_fn = make_loss_fn(args, t.render_cfg, t.bbox, t.model_cfg, with_tv=False, hwf=sc.hwf)
    master, opt = init_dp_zero(layout, t.state, args)
    dtype = getattr(torch, wire)
    step = make_dp_zero_train_step(layout, loss_fn, t.state, grad_dtype=dtype, broadcast_dtype=dtype)
    g = rank_generator(seed, layout, device)
    losses = [float(step(master, opt, batch, 0.0, g)["loss"]) for _ in range(n_steps)]
    moments = [tuple(st[k].shape) for st in opt.state.values() for k in ("exp_avg", "exp_avg_sq")]
    restored = None
    if save is not None:
        save_dp_zero(save, n_steps, layout, t.state, master, opt, args)
        fresh = Trainer(args, sc, device=device, seed=seed + 1)
        master2, opt2 = init_dp_zero(layout, fresh.state, args)
        step_back = restore_dp_zero(save, layout, fresh.state, master2, opt2, args)
        restored = {"step": step_back,
                    "equal": all(torch.equal(a, b) for a, b in zip(master, master2))
                    and all(torch.equal(opt.state[a][k], opt2.state[b][k])
                            for a, b in zip(master, master2)
                            for k in ("exp_avg", "exp_avg_sq", "step"))}
    return {"losses": losses, "restored": restored, "master": [to_np(c) for c in master], "moments": moments,
            "exp_avg": [to_np(opt.state[c]["exp_avg"]) for c in master],
            "params": [tuple(p.shape) for p in t.state.net_parameters()
                       + t.state.table_parameters()],
            "batch": {k: to_np(v) for k, v in batch.items()}}


def one_device_run(rank, world, device, flags, n_steps, seed=3):
    """The one-device Trainer's n_steps on zero_run's fixed batch."""
    from hashnerf_torch.train.driver import Trainer

    args = small_args([*DET, *flags])
    t = Trainer(args, scene(), device=device, seed=seed)
    scale_tables(t.state)
    batch = t.sample_image(0, args.N_rand, False)
    losses = [float(t.step(batch)["loss"]) for _ in range(n_steps)]
    return {"losses": losses, "state": state_np(t.state)}


def encoder_run(rank, world, device, n_data, n_model, table, x, bbox):
    """The level-sharded encoder at (n_data, n_model) on this rank's rows
    of x and levels of table; the loss sum(f^2) of its rows, backward, the
    level gradient summed over the data group. Returns (rows, features,
    model index, level gradient)."""
    from hashnerf_torch.ops.hash_encoding import HashGridConfig
    from hashnerf_torch.parallel.mesh import all_reduce, row_range, shard_rays
    from hashnerf_torch.parallel.table_sharded import (
        make_sharded_encoder, make_table_mesh, shard_table,
    )

    layout = make_table_mesh(n_data, n_model)
    cfg = HashGridConfig(n_levels=table.shape[0], n_features_per_level=table.shape[2],
                         log2_hashmap_size=int(np.log2(table.shape[1])), base_resolution=4,
                         finest_resolution=64)
    local = shard_table(layout, torch.from_numpy(table)).clone().requires_grad_(True)
    xs = shard_rays(layout, torch.from_numpy(x))
    b = torch.from_numpy(bbox)
    feats, keep = make_sharded_encoder(layout, cfg)(local, xs, b[0], b[1])
    (feats ** 2).sum().backward()
    if layout.data_group is not None:
        all_reduce(local.grad, layout.data_group)
    return {"rows": row_range(layout, x.shape[0]), "feats": to_np(feats),
            "keep": keep.numpy().copy(), "model": layout.model_index, "grad": to_np(local.grad)}


def table_run(rank, world, device, n_data, n_model, n_steps, save=None, restore=None,
              jax_ckpt=None, seed=3, next_seed=None):
    """The table-sharded trainer at (n_data, n_model): n_steps on
    sample_batch from U(-1, 1) tables (or from the checkpoint `restore`),
    then a checkpoint to `save`, then (next_seed) one more step's loss.
    jax_ckpt: a JAX checkpoint restored into a fresh trainer first, whose
    state is returned. Returns the losses, this rank's state and its model
    index."""
    from hashnerf_torch.parallel.table_sharded import (
        make_table_mesh, make_table_sharded_trainer, restore_table_sharded, save_table_sharded,
    )

    layout = make_table_mesh(n_data, n_model)
    args = small_args(["--n_levels", "8", *DET])
    out = {"model": layout.model_index}
    if jax_ckpt is not None:
        jt = make_table_sharded_trainer(layout, args, scene(), device=device, seed=11)
        out["jax_step"] = restore_table_sharded(jax_ckpt, jt)
        out["jax_state"] = state_np(jt.state)
        out["jax_moments"] = [to_np(st["exp_avg"]) for st in jt.optimizer.state.values()]
    t = make_table_sharded_trainer(layout, args, scene(), device=device, seed=seed)
    if restore is None:
        scale_tables(t.state)  # the same U(-1, 1) levels as the whole table's
    else:
        out["restored_step"] = restore_table_sharded(restore, t)
    losses = [float(t.step(t.sample_batch(False))["loss"]) for _ in range(n_steps)]
    if save is not None:
        save_table_sharded(save, t)
    out.update(losses=losses, state=state_np(t.state), global_step=t.global_step,
               exp_avg=[to_np(st["exp_avg"]) for st in t.optimizer.state.values()])
    if next_seed is not None:
        out["next_loss"] = next_step_loss(t, next_seed)
    return out


def table_suite_rank(rank, world, device, n_data, n_model, enc_inputs, runs):
    """encoder_run at (n_data, n_model) on enc_inputs, then table_run with
    each of runs {name: kwargs}."""
    out = {"enc": encoder_run(rank, world, device, n_data, n_model, *enc_inputs)}
    for name, kw in runs.items():
        out[name] = table_run(rank, world, device, n_data, n_model, **kw)
    return out


def dp_suite_rank(rank, world, device, runs):
    """trainer_run of each of runs {name: (flags, n_steps, mode)}."""
    return {name: trainer_run(rank, world, device, *spec) for name, spec in runs.items()}


def zero_suite_rank(rank, world, device, jax_state, batch, ckpt):
    """The ZeRO-1 runs of tests/test_torch_parallel.py: one fp32 step from
    the JAX state on its batch, 8 fp32 steps (against the one-device
    Trainer; then checkpointed to ckpt and restored), 8 bf16 steps."""
    return {
        "jax": zero_run(rank, world, device, [], 1, "float32", jax_state=jax_state,
                        settings=JAX_SETTINGS, batch=batch),
        "one": zero_run(rank, world, device, ["--sparse-loss-weight", "0"], 8, "float32",
                        save=ckpt),
        "bf16": zero_run(rank, world, device, [], 8, "bfloat16"),
    }


def card_dp_rank(rank, world, device, n_steps=8):
    """On the card: a data-parallel Trainer (a layout over the world's ranks,
    one rank too) and the
    one-process Trainer from one seed and table; before each of n_steps
    steps the one-process Trainer takes the DP one's state, then both step
    on the batch each samples (their generators in lockstep). Returns, a
    step, the loss difference, the MLP gradient entries that differ and
    whether the table gradients lie in the atomics' row gate."""
    from hashnerf_torch.parallel.mesh import collective_counts, make_mesh
    from hashnerf_torch.train.driver import Trainer

    flags = ["--device", str(device)]
    dp = Trainer(small_args(flags + ["--num_devices", str(world)]), scene(), device=device, seed=3,
                 layout=make_mesh(world))
    one = Trainer(small_args(flags), scene(), device=device, seed=3)
    scale_tables(dp.state)
    steps = []
    for _ in range(n_steps):
        with torch.no_grad():
            for a, b in zip(one.state.parameters(), dp.state.parameters()):
                a.copy_(b)
        if dp.optimizer.state:
            one.optimizer.load_state_dict(dp.optimizer.state_dict())
        m1 = one.step(one.sample_batch(False))
        m2 = dp.step(dp.sample_batch(False))
        l1, l2 = float(m1["loss"]), float(m2["loss"])
        mlp = sum(int((a.grad != b.grad).sum())
                  for a, b in zip(one.state.net_parameters(), dp.state.net_parameters()))
        ok = all(bool(((b.grad - a.grad).abs()
                       <= 2e-5 * a.grad.abs().reshape(-1, a.shape[-1]).sum(-1, keepdim=True)
                       .reshape(*a.shape[:-1], 1) + 1e-6).all())
                 for a, b in zip(one.state.table_parameters(), dp.state.table_parameters()))
        steps.append({"loss_rel_diff": abs(l1 - l2) / abs(l1), "mlp_grad_entries_differing": mlp,
                      "table_grad_in_row_gate": ok})
    return {"backend": torch.distributed.get_backend(), "steps": steps,
            "all_reduce_calls": collective_counts()["all_reduce"]}


def card_graphed_global_rank(rank, world, device, settings):
    """On the card: a data-parallel Trainer with global culling (settings:
    the args to set on the parser's defaults), its tables scaled to
    U(-1, 1); 8 eager steps (the grid fills, RAdam's gate opens), then 16
    steps from one state and generator state twice: eagerly, and as one
    run_steps(16) block (captured with the culling's all-gather and
    reduce-scatter, then replayed); then one more block. Returns whether
    the block's state lies within the atomics' row gate of the eager
    steps', the keeps, the losses and the collectives a replayed step
    ran."""
    from hashnerf_torch.data.synthetic import make_synthetic_scene
    from hashnerf_torch.parallel.mesh import collective_counts, make_mesh
    from hashnerf_torch.train.config import config_parser
    from hashnerf_torch.train.driver import Trainer

    args = config_parser().parse_args(["--num_devices", str(world)])
    for k, v in settings.items():
        setattr(args, k, v)
    t = Trainer(args, make_synthetic_scene(H=32, W=32, n_train=3, n_test=1), device=device,
                layout=make_mesh(world))
    with torch.no_grad():
        for p in t.state.table_parameters():
            p.mul_(1e4)
    for _ in range(8):
        t.step(t.sample_batch(False))
    snap = [x.detach().clone() for x in t.training_state()]
    rng, ready = t.generator.get_state(), t._occ_ready
    for _ in range(16):
        m_eager = t.step(t.sample_batch(False))
    eager = [x.detach().clone() for x in t.training_state()]
    eager_keep = t.last_occ_keep
    with torch.no_grad():
        for x, s in zip(t.training_state(), snap):
            x.copy_(s)
    t.generator.set_state(rng)
    t.global_step, t._occ_ready = 8, ready
    m_block = t.run_steps(16, block_size=16)
    block_keep = t.last_occ_keep
    in_gate = True
    for g, w in zip(t.training_state(), eager):
        w2 = w.reshape(-1, w.shape[-1]) if w.dim() > 1 else w.reshape(-1, 1)
        d = (g.reshape(w2.shape) - w2).abs()
        in_gate &= bool((d <= 2e-5 * w2.abs().sum(-1, keepdim=True) + 1e-6).all())
    c0 = collective_counts()
    t.run_steps(16, block_size=16)
    c1 = collective_counts()
    return {"backend": torch.distributed.get_backend(), "in_row_gate": in_gate,
            "keeps": [eager_keep, block_keep, t.last_occ_keep],
            "losses": [float(m_eager["loss"]), float(m_block["loss"])],
            "per_replayed_step": {k: (c1[k] - c0[k]) / 16 for k in c0}}

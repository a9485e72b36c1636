"""Replay a failed llff view gate's file (chip_smoke.py::save_view_failure)
through the JAX package, stage by stage, on the CPU:

    JAX_PLATFORMS=cpu python tests/view_replay.py chiprun_out/llff_view_failure.pt

chip_smoke.replay_view replays the file through the port's CPU route. Here
the saved weights are carried across to a JAX state (the port's converter,
hashnerf_torch/convert.py, checks their layout on the way back), and JAX's
coarse pass, sample_pdf and fine pass run on the saved rays as JAX's
render_rays runs them unculled and in eval mode. Prints one JSON line per
saved ray: its rgb and its coarse weights from the card, the port's CPU
replay and JAX, and the largest difference of each stage between them."""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)  # chip_smoke.py, beside the packages


def _layer(linear):
    p = {"w": linear.weight.detach().cpu().numpy().T.copy()}
    if linear.bias is not None:
        p["b"] = linear.bias.detach().cpu().numpy().copy()
    return p


def jax_tree(module):
    """A port MLP's parameters in the JAX layout (convert.py's, inverted):
    {name: {"w": (in, out)[, "b"]}} or {name: [{"w", ...}, ...]}."""
    import torch

    return {name: _layer(child) if isinstance(child, torch.nn.Linear) else [_layer(c) for c in child]
            for name, child in module._modules.items()}


def jax_state(saved):
    """(JAX state, JAX query_fn) holding a save_view_failure payload's
    weights. The JAX layout goes back through convert.load_jax_state into a
    fresh port state, which must equal the saved one."""
    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    from hashnerf_torch.convert import load_jax_state
    from hashnerf_torch.models.factory import NGPState
    from hashnerf_tpu.models.factory import ModelConfig as JModelConfig, NGPState as JState
    from hashnerf_tpu.models.factory import create_model
    from hashnerf_tpu.ops.hash_encoding import HashGridConfig as JHashGridConfig

    port = cs.load_view_state(torch, saved)
    table = port.hash_table.detach().numpy()
    coarse = jax_tree(port.coarse)
    fine = jax_tree(port.fine) if port.fine is not None else None
    back = load_jax_state(NGPState(port.cfg, device="cpu"), table, coarse, fine)
    for (k, a), (_, b) in zip(port.state_dict().items(), back.state_dict().items()):
        if not torch.equal(a, b):
            raise ValueError(f"{k} does not survive the carry to JAX and back")
    mc = dict(saved["model_cfg"])
    hg = JHashGridConfig(**mc.pop("hash_grid"))
    fields = set(JModelConfig.__dataclass_fields__)
    jcfg = JModelConfig(hash_grid=hg, **{k: v for k, v in mc.items() if k in fields})
    _, query = create_model(jax.random.PRNGKey(0), jcfg)
    to_j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    state = JState(hash_table=jnp.asarray(table), coarse=to_j(coarse),
                   fine=None if fine is None else to_j(fine))
    return state, query


def jax_stages(saved):
    """JAX's stages of the saved rays, as numpy: {"coarse": {z, raw,
    weights, rgb}, "sample_pdf": {z}, "fine": {z, raw, weights, rgb}}, each
    pass as JAX's render_rays composes it (unculled, eval mode), and
    "render_rays": JAX's own render_rays' rgb0 and rgb_map."""
    import jax.numpy as jnp

    from hashnerf_tpu.ops.sampling import sample_pdf, stratified_z_vals
    from hashnerf_tpu.ops.volume import raw2outputs
    from hashnerf_tpu.render.renderer import RenderConfig as JRenderConfig, render_rays

    state, query = jax_state(saved)
    rc = saved["render_cfg"]
    if not (rc["occupancy"] is None and not rc["perturb"] and rc["raw_noise_std"] == 0.0):
        raise ValueError("the replay runs an unculled eval render")
    o, d, v = (jnp.asarray(r.numpy()) for r in saved["rays"])
    bbox = jnp.asarray(saved["bbox"].numpy())
    R = o.shape[0]
    near = jnp.full((R,), saved["near"], jnp.float32)
    far = jnp.full((R,), saved["far"], jnp.float32)

    def march(z, fine):
        raw = query(state, o[:, None, :] + d[:, None, :] * z[..., None], v, bbox, fine=fine)
        out = raw2outputs(raw, z, d, 0.0, rc["white_bkgd"])
        return {"z": z, "raw": raw, "weights": out.weights, "rgb": out.rgb_map}

    z = stratified_z_vals(near, far, rc["N_samples"], rc["lindisp"])
    coarse = march(z, False)
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    z_samples = sample_pdf(None, mids, coarse["weights"][..., 1:-1], rc["N_importance"], det=True)
    fine = march(jnp.sort(jnp.concatenate([z, z_samples], -1), -1), True)
    fields = set(JRenderConfig.__dataclass_fields__)
    ret = render_rays(state, query, o, d, v, near, far, bbox, None,
                      JRenderConfig(**{k: val for k, val in rc.items() if k in fields}))
    to_np = lambda st: {k: np.asarray(x) for k, x in st.items()}
    return {"coarse": to_np(coarse), "sample_pdf": {"z": np.asarray(z_samples)},
            "fine": to_np(fine),
            "render_rays": {"rgb0": np.asarray(ret["rgb0"]), "rgb_map": np.asarray(ret["rgb_map"])}}


def main(argv=None) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    import chip_smoke as cs

    path = (argv or sys.argv[1:])[0]
    rep = cs.replay_view(torch, path)
    card, cpu = rep["saved"]["stages"]["card"], rep["cpu"]
    jx = jax_stages(rep["saved"])
    diff = lambda a, b: float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
    for i, view in enumerate(rep["saved"]["saved_view_idx"].tolist()):
        line = {"ray": view}
        for stage, keys in (("coarse", ("raw", "weights", "rgb")), ("sample_pdf", ("z",)),
                            ("fine", ("z", "raw", "weights", "rgb"))):
            for k in keys:
                line[f"{stage}_{k}_card_vs_cpu"] = diff(card[stage][k][i], cpu[stage][k][i])
                line[f"{stage}_{k}_cpu_vs_jax"] = diff(cpu[stage][k][i], jx[stage][k][i])
        line["rgb"] = {"card": card["fine"]["rgb"][i].tolist(), "cpu": cpu["fine"]["rgb"][i].tolist(),
                       "jax": jx["fine"]["rgb"][i].tolist()}
        print(json.dumps(line), flush=True)
    print(json.dumps({"hold_ok": rep["hold"][0], "hold": rep["hold"][1]["failing"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

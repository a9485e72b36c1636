"""What the benchmark computes, at the tiny sizes of tests/tiny.py, for a
comparison of two trees of nerfbench on the CPU. Run it from each tree's
root and compare the two files byte for byte:

    python nerfbench/tests/compare_tiny.py OUT.json
    cmp A.json B.json

It runs the tiny copy of every cell in BENCHMARK.json, untraced (a window
of one unit) and traced, on one thread at a fixed seed, and writes: the
`compared` values (repr), each per-layer reading that the tree's readers
give on the run's own ctx with a fixed stand-in trace and slice (so that
the host clock drops out), the ctx's encode counts and launches, and the
full-size FLOP counts of each configuration. It also runs on a tree from
before model families (FLOP counts in counts.py), so a change to the
harness's structure can be held against the tree it started from.
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

torch.set_num_threads(1)
from nerfbench import counts, harness, spec  # noqa: E402
from nerfbench.tests.tiny import tiny_config, tiny_traffic  # noqa: E402

SEED = 2**31 + 4242
TRACE = {"ops": {"hash_encode_fwd_kernel": 0.003, "packed_encode_fwd_kernel": 0.002,
                 "ampere_sgemm_128x64": 0.004, "CatArrayBatchedCopy": 0.001,
                 "field_colour_input_k": 0.0005, "field_raw_k": 0.00025},
         "busy_s": 0.75, "window_s": 1.0, "idle": {}}
SLICE = {"units": 3, "seconds": 0.5, "enqueue_s": 0.0125}


def main(out_path: str) -> None:
    bench = spec.load_benchmark()
    real_read = spec.read_metrics
    captured = {}

    def read_twice(entries, ctx, base=spec.HERE):
        """The readers on the stand-in trace (kept), then on the run's own."""
        fake = dict(ctx, on_card=True, trace=TRACE, slice=SLICE, traced_units=3)
        captured["encode"] = ctx.get("encode")
        captured["launches"] = ctx.get("launches")
        captured["metrics"] = {k: repr(v["value"]) for k, v in real_read(entries, fake, base).items()}
        return real_read(entries, ctx, base)

    spec.read_metrics = read_twice
    out = {"runs": {}, "flops": {}}
    for w in bench["workloads"]:
        name = w["name"]
        for trace in (False, True):
            captured.clear()
            res = harness.run_cell(w, tiny_config(w["config"]), tiny_traffic(w["traffic"]),
                                   spec.limits(name), SEED, 1e-6, trace, "cpu",
                                   spec.metrics_for(bench, name, "per_layer"))
            rec = {"correct": res["correct"],
                   "compared": {k: repr(v["value"]) for k, v in res["compared"].items()}}
            if trace:
                rec.update(per_layer=captured["metrics"], encode=captured["encode"],
                           launches=captured["launches"])
            out["runs"][f"{name}.trace{int(trace)}"] = rec
            print(name, "traced" if trace else "untraced", "correct" if rec["correct"] else
                  "NOT correct", flush=True)

    for name in sorted({c["name"] for c in bench["configs"]}):
        cfg = spec.config(name)
        s = cfg["settings"]
        if hasattr(counts, "macs_per_point"):  # a tree from before model families
            tf, rf = counts.train_flops_per_step(s), counts.render_flops_per_frame(s, 400, 400)
        else:
            fam = spec.family_of(cfg)
            tf, rf = fam.train_flops_per_step(s), fam.render_flops_per_frame(s, 400, 400)
        out["flops"][name] = [repr(tf), repr(rf)]
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print("wrote", out_path)


if __name__ == "__main__":
    main(sys.argv[1])

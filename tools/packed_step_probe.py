#!/usr/bin/env python3
"""The n=32 packed train step of the port under a given checkout, on the
card: what makes it repeat or not, and what it costs.

    python3 tools/packed_step_probe.py --root DIR --tag NAME --out OUT_DIR
    python3 tools/packed_step_probe.py --compare NAME_A NAME_B --out OUT_DIR

``--root`` is the directory that holds the ``topo_audio_autoencoder_torch``
package to probe (``.`` for this checkout; an unpacked ``git archive`` of
another commit to compare two). One run, on the repo's best geometry (n=32,
ranks 2-3 packed to 512 and 256 rows, fp32, B=16 x G=3, seeded weights and
clips):

1. one forward and backward under ``torch.use_deterministic_algorithms(True,
   warn_only=True)``: the ops torch warns have no deterministic kernel;
2. three identical forward and backward passes with cuDNN deterministic:
   the gradient leaves that differ from the first, and the relative L2;
3. the loss, its components and the encoder masks, saved to
   ``<out>/<tag>.pt`` (``--compare`` holds two tags' bit for bit);
4. the train step as users run it (cuDNN default): a warm-up and 5 steps
   on the host clock, each ended by a synchronisation, and one step under
   torch.profiler (device ms, kernel launches).

Prints one JSON line. Run the trees to compare in one call, alternating.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import warnings
from pathlib import Path

PACKED = dict(num_vertices=32, num_bands=16, sccn_hidden_dim=64, n_sccn_layers=6, max_active_vertices=32,
              pack_capacities=(0, 0, 512, 256))
B, G, T, SEED, STEPS = 16, 3, 64000, 511990, 5


def clips(seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000.0
    x = [0.3 * np.sin(2 * np.pi * rng.uniform(100, 1000) * t + rng.uniform(0, 6)) + 0.01 * rng.standard_normal(T)
         for _ in range(B * G)]
    return np.stack(x).astype(np.float32).reshape(B, G, 1, T)


def probe(root: str, tag: str, out: Path) -> dict:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import topo_audio_autoencoder_torch as port
    from topo_audio_autoencoder_torch.training.train_step import make_loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = port.AudioAutoencoder.create(**PACKED, num_samples=T, seed=SEED, device="cuda")
    batch = torch.from_numpy(clips(7)).cuda()
    loss_and_grads = make_loss_and_grads(model, port.LossWeights())
    result = {"tag": tag, "package": port.__file__}

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loss_and_grads(batch, 1.0, SEED, 0)
        torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    result["nondeterministic_warnings"] = sorted({str(w.message).split(" does not have")[0] for w in caught
                                                  if "deterministic" in str(w.message)})
    runs = [loss_and_grads(batch, 1.0, SEED, 0) for _ in range(3)]
    first = runs[0][2]
    result["repeat_leaves_differ"] = [sum(not torch.equal(first[n], r[2][n]) for n in first) for r in runs[1:]]
    flat = [torch.cat([r[2][n].reshape(-1) for n in first]) for r in runs]
    result["repeat_rel_l2"] = [float((flat[0] - f).norm() / flat[0].norm()) for f in flat[1:]]
    result["leaves"] = len(first)
    with torch.no_grad():
        enc = model.encode(batch[:, 0], 1.0, train=True, generator=torch.Generator(device="cuda").manual_seed(3))
    out.mkdir(parents=True, exist_ok=True)
    torch.save({"loss": runs[0][0].cpu(), "components": {k: v.cpu() for k, v in runs[0][1].items()},
                "masks": [m.cpu() for m in enc.masks]}, out / f"{tag}.pt")
    result["loss"] = float(runs[0][0])
    torch.backends.cudnn.deterministic = False

    opt = port.make_optimizer(accumulate_grad_batches=1)
    state, step = port.create_train_state(model, opt), port.make_train_step(model, opt)
    times = []
    for i in range(STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch, 1.0, SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, 1.0, SEED)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    result.update(step_ms=times[1:], step_ms_median=statistics.median(times[1:]),
                  device_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
                  kernel_launches=sum(e.count for e in kernels))
    return result


def compare(a: str, b: str, out: Path) -> dict:
    import torch

    x, y = (torch.load(out / f"{t}.pt") for t in (a, b))
    return {"compare": [a, b], "loss_equal": torch.equal(x["loss"], y["loss"]),
            "components_equal": all(torch.equal(x["components"][k], y["components"][k]) for k in x["components"]),
            "masks_equal": all(torch.equal(p, q) for p, q in zip(x["masks"], y["masks"]))}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root")
    parser.add_argument("--tag")
    parser.add_argument("--compare", nargs=2)
    parser.add_argument("--out", required=True, type=Path, help="where each tag's loss and masks are saved")
    args = parser.parse_args()
    result = compare(*args.compare, args.out) if args.compare else probe(args.root, args.tag, args.out)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

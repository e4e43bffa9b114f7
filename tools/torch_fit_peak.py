"""Peak device memory of the port's full-width ImageNetSiftLcsFV fit, and
the largest allocations alive at that peak.

    python3 tools/torch_fit_peak.py [TREE]

TREE (default: this checkout) is the root of a checkout of the repository,
so that two commits can be compared in one run on one card (unpack the
other with ``git archive`` into a gitignored directory). It fits on
``chip_smoke.py``'s 8,192 synthetic 256x256 training images at the
reference's real-data settings, records the CUDA caching allocator's
history during the fit, and prints the peak and the fourteen largest
blocks live at the traced peak with the port's frames that allocated them.
Needs a CUDA device.
"""

import os
import sys

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, root)
os.chdir(root)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from keystone_tpu_torch.pipelines.images import imagenet_sift_lcs_fv as pipe  # noqa: E402


def where(event) -> str:
    frames = [f for f in event.get("frames", [])
              if "keystone_tpu_torch" in f["filename"] or "chip_smoke" in f["filename"]]
    return " <- ".join(f"{f['filename'].split('/keystone_tpu_torch/')[-1]}:{f['line']}:{f['name']}"
                       for f in frames[:4])


def main() -> None:
    train, _ = cs.full_width_data(np)
    conf = pipe.resolve_scale(pipe.ImageNetSiftLcsFVConfig(pca_dims=64, **pipe.REAL_SCALE))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=500000)
    pipe.fit(conf, train, 1000, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    events = torch.cuda.memory._snapshot()["device_traces"][0]
    torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, best, best_live = {}, 0, 0, {}
    for e in events:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > best:
                best, best_live = cur, dict(live)
        elif e["action"] == "free_requested" and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]
    print(f"{root}: peak {peak / 2**30:.4f} GiB; traced peak {best / 2**30:.4f} GiB over {len(events)} events")
    for e in sorted(best_live.values(), key=lambda e: -e["size"])[:14]:
        print(f"  {e['size'] / 2**30:.4f} GiB  {where(e)}")


if __name__ == "__main__":
    main()

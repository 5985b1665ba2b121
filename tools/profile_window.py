"""Profile phase 5b's eager decode step over and over, without and with
``chip_smoke.PROFILE_GUARD_S`` (ROADMAP Queue 3, fault 6).

The step is Llama-3-8B at full depth with int4 weights over an int4 pool,
about 3300 kernel launches.  For each setting of the guard the script
prints one JSON record: how often the profile's port kernels differed
from the launch counters' gain over the profiled call, the first such
differences, and the gaps, in microseconds, from the profiler's active
window's start to its first kernel and from its last kernel's end to the
window's end.  It needs the card; run it from the root of a checkout:

    python3 tools/profile_window.py [--reps N]
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=40,
                        help="profiles for each setting of the guard")
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the profiled step runs on the card",
              file=sys.stderr)
        return 1
    from k8s_llm_rca_tpu_torch.engine import make_engine
    from k8s_llm_rca_tpu_torch.models.llama import init_params
    from k8s_llm_rca_tpu_torch.ops import build
    from k8s_llm_rca_tpu_torch.utils.tokenizer import get_tokenizer

    build.build(cs.KERNELS)
    cfg, transform = cs.slice_model("llama3-8b", 4)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         tensor_transform=transform)
    engine = make_engine(cfg, cs.slice_engine_config(kv_cache_dtype="int4"),
                         params, get_tokenizer(vocab_size=cfg.vocab_size),
                         cuda_graphs=False)
    cs.warm_engine(engine, 2)
    step = cs.decode_step_fn(engine)
    for _ in range(2):
        step()
    guarded = cs.PROFILE_GUARD_S
    for guard in (0.0, guarded):
        cs.PROFILE_GUARD_S = guard    # profile_step reads it at each call
        t0 = time.perf_counter()
        missed, first, last = [], [], []
        for _ in range(args.reps):
            prof = cs.profile_step(step)
            seen = cs.profiled_launches(prof["events"])
            want = cs.counted_launches(prof["gain"])
            if seen != want:
                missed.append({"seen": seen, "want": want,
                               "first_kernel_us": prof["first_kernel_us"]})
            first.append(prof["first_kernel_us"])
            last.append(prof["last_kernel_us"])
        cs.emit("profile_window", model=cfg.name, weights="int4",
                kv_cache_dtype="int4", guard_s=guard, reps=args.reps,
                mismatches=len(missed), missed=missed[:5],
                first_kernel_us_min=float(np.min(first)),
                first_kernel_us_median=float(np.median(first)),
                last_kernel_us_min=float(np.min(last)),
                last_kernel_us_median=float(np.median(last)),
                seconds=time.perf_counter() - t0)
    cs.PROFILE_GUARD_S = guarded
    return 0


if __name__ == "__main__":
    sys.exit(main())

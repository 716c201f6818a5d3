#!/bin/bash
# Sharded training of the port on the four cards of one host, one JSON
# per run: one unsharded pallas run on one card, then `torchrun
# --nproc-per-node 4 -m ppnp_tpu_torch train --propagation sharded` on
# pallas/alltoall, xla/alltoall, xla/allgather, pallas with sparse X and
# pallas on the 2 x 2 hierarchical mesh (--n-slices 2), then `bench
# --training --propagation sharded`, then one sharded pallas `train
# --profile` of PROFILE_EPOCHS epochs (the chunks after the first 50 are
# traced, one trace_rank<r>.json a rank in the session's directory
# under OUT/profile, found through profiling.trace_path). Ends with a summary line per
# run: best and last epoch, valtest accuracy, ms an epoch (median over
# its 50-epoch chunks after the first) and whether every rank holds the
# same weights; and per rank of the traced run, the share of the traced
# window in which its card ran a kernel or a copy.
#
# Run from the root of a checkout: `bash four_cards.sh`. DATASET
# (ms_academic), EPOCHS (500), PROFILE_EPOCHS (60), DEVICE (cuda; cpu
# runs over gloo), NPROC (4) and OUT (build/four_cards) come from the
# environment; PROFILE_ONLY=1 runs the traced run alone.
DATASET=${DATASET:-ms_academic}; EPOCHS=${EPOCHS:-500}
PROFILE_EPOCHS=${PROFILE_EPOCHS:-60}
DEVICE=${DEVICE:-cuda}; NPROC=${NPROC:-4}; OUT=${OUT:-build/four_cards}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
  > "$OUT/cards.txt" 2>&1
if [ "${PROFILE_ONLY:-0}" != 1 ]; then
python -m ppnp_tpu_torch train --dataset "$DATASET" --backend pallas \
  --device "$DEVICE" --max-epochs "$EPOCHS" --print-interval 0 \
  > "$OUT/single_pallas.json" 2> "$OUT/single_pallas.err"
echo "single pallas rc=$?"
for run in "pallas alltoall auto 1" "xla alltoall auto 1" \
           "xla allgather auto 1" "pallas alltoall sparse 1" \
           "pallas alltoall auto 2"; do
  set -- $run
  f="$OUT/train_$1_$2_$3_$4"
  timeout 900 torchrun --standalone --nproc-per-node "$NPROC" \
    -m ppnp_tpu_torch train --propagation sharded --dataset "$DATASET" \
    --backend "$1" --exchange "$2" --x-format "$3" --n-slices "$4" \
    --max-epochs "$EPOCHS" --print-interval 0 --device "$DEVICE" \
    > "$f.json" 2> "$f.err"
  echo "$run rc=$?"
done
timeout 900 torchrun --standalone --nproc-per-node "$NPROC" \
  -m ppnp_tpu_torch bench --training --propagation sharded \
  --dataset "$DATASET" --backends pallas --epochs 200 --device "$DEVICE" \
  > "$OUT/bench_training.json" 2> "$OUT/bench_training.err"
echo "bench rc=$?"
fi
rm -rf "$OUT/profile"
timeout 900 torchrun --standalone --nproc-per-node "$NPROC" \
  -m ppnp_tpu_torch train --propagation sharded --dataset "$DATASET" \
  --backend pallas --max-epochs "$PROFILE_EPOCHS" --print-interval 0 \
  --device "$DEVICE" --profile "$OUT/profile" \
  > "$OUT/train_profile.json" 2> "$OUT/train_profile.err"
echo "profile rc=$?"
python3 - "$OUT" <<'PY'
import glob, json, os, statistics, sys

from ppnp_tpu_torch.profiling import trace_path

def union_ms(intervals):
    busy, end = 0.0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            busy, end = busy + hi - lo, hi
        elif hi > end:
            busy, end = busy + hi - end, hi
    return busy / 1e3


try:
    session = trace_path(os.path.join(sys.argv[1], "profile"), 0).parent
    traces = sorted(str(p) for p in session.glob("trace_rank*.json"))
except FileNotFoundError as e:
    print("profile:", e)
    traces = []
for f in traces:
    ev = json.load(open(f))["traceEvents"]
    host = [e for e in ev if e.get("cat") in ("cpu_op", "user_annotation")
            and "dur" in e]
    dev = [e for e in ev
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    # an NCCL kernel runs while it waits for the other ranks: busy with
    # and without them
    nccl = ["nccl" in e.get("name", "").lower() for e in dev]
    span = (max(e["ts"] + e["dur"] for e in host)
            - min(e["ts"] for e in host)) / 1e3 if host else 0.0
    busy = union_ms((e["ts"], e["ts"] + e["dur"]) for e in dev)
    work = union_ms((e["ts"], e["ts"] + e["dur"])
                    for e, n in zip(dev, nccl) if not n)
    print(os.path.basename(f), "traced ms", round(span, 3),
          "device busy ms", round(busy, 3), "share",
          round(busy / span, 4) if span else None, "without NCCL ms",
          round(work, 3), "share", round(work / span, 4) if span else None,
          "NCCL kernels", sum(nccl), "kernels",
          sum(e.get("cat") == "kernel" for e in ev))
for f in sorted(glob.glob(os.path.join(sys.argv[1], "*.json"))):
    try:
        r = json.loads(open(f).read())
    except ValueError as e:
        print(os.path.basename(f), "unreadable:", e)
        continue
    if "chunk_times" not in r:
        print(os.path.basename(f), json.dumps(r))
        continue
    per = [s / n for n, s in r["chunk_times"][1:] or r["chunk_times"]]
    print(os.path.basename(f), "best", r["best_epoch"], "last",
          r["last_epoch"], "valtest", r["valtest"]["accuracy"], "x",
          r["x_format"], "ms/epoch", 1e3 * statistics.median(per),
          "ranks", r.get("ranks"))
PY

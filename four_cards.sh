#!/bin/bash
# Sharded training of the port on the four cards of one host, one JSON
# per run: one unsharded pallas run on one card, then `torchrun
# --nproc-per-node 4 -m ppnp_tpu_torch train --propagation sharded` on
# pallas/alltoall, xla/alltoall, xla/allgather, pallas with sparse X and
# pallas on the 2 x 2 hierarchical mesh (--n-slices 2), then `bench
# --training --propagation sharded`. Ends with a summary line per run:
# best and last epoch, valtest accuracy, ms an epoch (median over its
# 50-epoch chunks after the first) and whether every rank holds the
# same weights.
#
# Run from the root of a checkout: `bash four_cards.sh`. DATASET
# (ms_academic), EPOCHS (500), DEVICE (cuda; cpu runs over gloo), NPROC
# (4) and OUT (build/four_cards) come from the environment.
DATASET=${DATASET:-ms_academic}; EPOCHS=${EPOCHS:-500}
DEVICE=${DEVICE:-cuda}; NPROC=${NPROC:-4}; OUT=${OUT:-build/four_cards}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
  > "$OUT/cards.txt" 2>&1
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
python3 - "$OUT" <<'PY'
import glob, json, os, statistics, sys
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

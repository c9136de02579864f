#!/usr/bin/env bash
# The quality program of the port on one card, one head at a time: the
# hard synthetic VOC (1024 train / 128 val) and a 1500-step classifier
# pretrain, then the head's curve at 600, 1200, 2400, 4800 and 9600
# steps, one process a stage (quality_curve reads the newest snapshot and
# trains only the delta); the classifier's val accuracy; int8_quality on
# the last snapshot; a second draw (--seed 1) to 2400 in a clean root
# holding the same fixture and pretrain. Every process's output is
# appended to OUT/<head>.log with a WALL line of its seconds.
#
# Usage: bash tensorflow_yolo2_torch/quality_program.sh v1|v2|v2p ROOT OUT
#
# STAGES, DRAW2_STAGES, DRAW_SEEDS (the seeds of the further draws, each
# in a root of its own), PRETRAIN, FIX and DEVICE_ARGS override the
# program's settings, e.g. a tiny run on the CPU:
#   STAGES="1 2" DRAW2_STAGES=1 PRETRAIN=1 DEVICE_ARGS="--device cpu" \
#   FIX="--n-train 8 --n-val 4 --batch 2 --eval-max-images 4" \
#   bash tensorflow_yolo2_torch/quality_program.sh v2p /tmp/q /tmp/q_out
set -uo pipefail
HEAD="$1"
ROOT="$2"
OUT="$3"
STAGES="${STAGES:-600 1200 2400 4800 9600}"
DRAW2_STAGES="${DRAW2_STAGES:-600 1200 2400}"
DRAW_SEEDS="${DRAW_SEEDS:-1}"
PRETRAIN="${PRETRAIN:-1500}"
FIX="${FIX:---n-train 1024 --n-val 128 --bn-momentum 0.9 --grad-clip 5}"
DEVICE_ARGS="${DEVICE_ARGS:-}"
case "$HEAD" in
  v1) FLAGS=""; INT8="" ;;
  v2) FLAGS="--v2 --anchors kmeans"; INT8="--v2" ;;
  v2p) FLAGS="--v2 --passthrough --anchors kmeans"
       INT8="--v2 --passthrough" ;;
  *) echo "head must be v1, v2 or v2p" >&2; exit 2 ;;
esac
cd "$(dirname "$0")/.."
mkdir -p "$ROOT" "$OUT"
LOG="$OUT/$HEAD.log"
FAILED=0

run() {  # label, command...: the command's output and its wall seconds
  local label="$1"; shift
  echo "==== $(date +%H:%M:%S) $label: $* ====" >> "$LOG"
  local t0 t1
  t0=$(date +%s.%N)
  "$@" >> "$LOG" 2>&1 || { echo "FAILED $label" >> "$LOG"; FAILED=1; }
  t1=$(date +%s.%N)
  echo "WALL $label $(awk "BEGIN {print $t1 - $t0}")" >> "$LOG"
}

curve() {  # extra quality_curve arguments
  python -m tensorflow_yolo2_torch.entries.quality_curve $FIX $FLAGS \
    --pretrain-iters "$PRETRAIN" $DEVICE_ARGS "$@"
}

export TFY2_ROOT="$ROOT"
# the fixture and the pretrain alone (no stage at 0 steps to train)
run pretrain curve --stages 0
run pretrain_accuracy python -m \
  tensorflow_yolo2_torch.entries.imagenet_test_darknet --batch-size 100 \
  $DEVICE_ARGS
for s in $STAGES; do
  run "stage $s" curve --stages "$s"
done
run int8 python -m tensorflow_yolo2_torch.entries.int8_quality $INT8 \
  --max-images 256 $DEVICE_ARGS

# further draws, each in a clean root with the same fixture and pretrain
for seed in $DRAW_SEEDS; do
  DRAW="${ROOT}_seed$seed"
  mkdir -p "$DRAW/ckpts/darknet19" "$DRAW/data"
  cp -r "$ROOT/data/VOCdevkit" "$ROOT/data/ILSVRC" "$DRAW/data/"
  cp -r "$ROOT/cache" "$DRAW/"
  cp -r "$ROOT/ckpts/darknet19/ilsvrc_2017_cls" "$DRAW/ckpts/darknet19/"
  export TFY2_ROOT="$DRAW"
  for s in $DRAW2_STAGES; do
    run "seed$seed stage $s" curve --stages "$s" --seed "$seed"
  done
done
grep -h "^STAGE\|^INT8_QUALITY\|^WALL\|^top-1\|^FAILED" "$LOG"
exit $FAILED

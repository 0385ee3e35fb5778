#!/usr/bin/env bash
# Crash-recovery smoke of the PyTorch port's train entry point
# (python -m cgnn_tpu_torch.train), the twin of scripts/crash_smoke.sh:
#
#  1. SIGTERM a training run mid-flight -> it must save a resumable
#     checkpoint at the next boundary and exit with the resumable code 75;
#  2. kill -9 a second run (no grace at all) -> the versioned atomic
#     checkpoint layout must still hold a committed save;
#  3. resume both with --resume auto -> the runs complete to the full
#     epoch count.
#
# Runs on the CPU (--device cpu, the kernels' plain versions), on the COO
# layout and synthetic data, like the JAX twin. DEVICE=cuda runs it on a
# card.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
DEVICE=${DEVICE:-cpu}
# enough epochs that the kill always lands while training still runs
EPOCHS=40
CKPT=$(mktemp -d)
trap 'rm -rf "$CKPT"' EXIT
ARGS=(--synthetic 48 --device "$DEVICE" --epochs "$EPOCHS" --optim Adam
      -b 16 --radius 5 --layout coo --print-freq 0)

wait_for_commit() { # <dir>: block until a committed save exists
  for _ in $(seq 1 900); do
    compgen -G "$1/ckpt-*/MANIFEST.json" >/dev/null && return 0
    sleep 0.2
  done
  echo "no committed checkpoint appeared under $1" >&2
  return 1
}

run() { # <leg> <extra args...>: the entry point (exec: $! is its pid)
  local leg=$1
  shift
  exec python -m cgnn_tpu_torch.train "${ARGS[@]}" --ckpt-dir "$CKPT/$leg" \
    --out-dir "$CKPT/out_$leg" "$@"
}

echo "== leg 1: SIGTERM -> resumable exit 75 =="
run a >"$CKPT/run_a.log" 2>&1 &
PID=$!
wait_for_commit "$CKPT/a"
kill -TERM "$PID"
set +e; wait "$PID"; RC=$?; set -e
if [ "$RC" -ne 75 ]; then
  echo "expected resumable exit 75, got $RC" >&2
  tail -30 "$CKPT/run_a.log" >&2
  exit 1
fi
grep -q "preempted: resumable checkpoint saved" "$CKPT/run_a.log"

echo "== leg 2: kill -9 mid-run leaves a committed save =="
run b >"$CKPT/run_b.log" 2>&1 &
PID=$!
wait_for_commit "$CKPT/b"
kill -KILL "$PID"
set +e; wait "$PID"; RC=$?; set -e
[ "$RC" -eq 137 ] || { echo "expected 137 after kill -9, got $RC" >&2; exit 1; }
compgen -G "$CKPT/b/ckpt-*/MANIFEST.json" >/dev/null

echo "== leg 3: --resume auto completes both runs to the full epoch count =="
for leg in a b; do
  (run "$leg" --resume auto) >"$CKPT/resume_$leg.log" 2>&1
  grep -q "resumed from" "$CKPT/resume_$leg.log"
  grep -q "Epoch $((EPOCHS - 1)):" "$CKPT/resume_$leg.log"
  grep -Fq "** test mae:" "$CKPT/resume_$leg.log"
  echo "leg $leg resumed and completed"
done

echo "torch crash-recovery smoke: PASS"

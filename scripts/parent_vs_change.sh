#!/bin/bash
# Times two checkouts of the port on one card, in turns (A, B, B, A): the
# kernels phase of each one's chip_smoke.py (every hand kernel against its
# plain version, timed) and scripts/b6_times.py (B6 and its quantize passes,
# the same cases for both). Each checkout builds its own kernels at its
# first run.
#
#   scripts/parent_vs_change.sh A_DIR B_DIR OUT_DIR [KERNELS]
#
# KERNELS (optional, comma-separated) cuts each kernels phase down to those
# kernels. Logs: OUT_DIR/{a,b}{1,2}.kernels.log, b6 times appended to
# OUT_DIR/b6_times.jsonl. Exits non-zero if any run fails.
set -u
a=$(cd "$1" && pwd); b=$(cd "$2" && pwd); kern=${4:-}
mkdir -p "$3"; out=$(cd "$3" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
rc=0
for run in a1 b1 b2 a2; do
  tree=$a; [ "${run:0:1}" = b ] && tree=$b
  echo "== $run: $tree" | tee -a "$out/b6_times.jsonl"
  (cd "$tree" && python3 chip_smoke.py --phases env,build,kernels \
      ${kern:+--kernels "$kern"} > "$out/$run.kernels.log" 2>&1) || rc=1
  tail -n 2 "$out/$run.kernels.log"
  python3 "$here/scripts/b6_times.py" --root "$tree" \
      --out "$out/b6_times.jsonl" > /dev/null || rc=1
done
exit $rc

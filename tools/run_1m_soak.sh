#!/bin/bash
# 1M-event production soak (BASELINE ladder config 5) with bounded disk
# use: the full Spyral HDF5 output is written through the normal writer
# path, each completed run file is size-verified and then RECYCLED so the
# retained set stays at 3 files (~3.3 GB) of the ~221 GB of 1M-event
# output.
#
# Pruned files are MOVED into clouds/.recycle instead of unlinked: the
# writer child renames one onto each new run file's path and overwrites
# it in place through the in-memory HDF5 image path (no O_TRUNC), so the
# file's already-faulted pages stay warm instead of paying a first-touch
# page fault on every fresh page.
#
# Usage: tools/run_1m_soak.sh [outdir]   (default /dev/shm/soak1m)
# Results land in $outdir/clouds (last 3 run files + manifests) and the
# bench JSON line on stdout. Needs a GPU (bench.py refuses to run
# without one).
set -u
OUT=${1:-/dev/shm/soak1m}
mkdir -p "$OUT/clouds/.recycle"
FLAG=$(mktemp)
(
  i=0
  while [ -f "$FLAG" ]; do
    for f in $(ls -t "$OUT"/clouds/run_*.h5 2>/dev/null | tail -n +4); do
      sz=$(stat -c %s "$f" 2>/dev/null || echo 0)
      if [ "$sz" -gt 50000000 ]; then
        # keep at most 2 spares; recycle the rest of the names forever
        spares=$(ls "$OUT"/clouds/.recycle/*.h5 2>/dev/null | wc -l)
        if [ "$spares" -lt 2 ]; then
          mv "$f" "$OUT/clouds/.recycle/spare_$i.h5"
          i=$((i + 1))
        else
          rm -f "$f"
        fi
        echo "$(date +%H:%M:%S) pruned $f ($sz bytes)" >> "$OUT/pruner.log"
      fi
    done
    sleep 45
  done
) &
PRUNER=$!
BENCH_EVENTS=1000000 BENCH_BATCH=${BENCH_BATCH:-384} BENCH_OUTDIR="$OUT" \
  ATTPC_TPU_TIMING=1 python "$(dirname "$0")/../bench.py"
rc=$?
rm -f "$FLAG"
wait $PRUNER 2>/dev/null
exit $rc

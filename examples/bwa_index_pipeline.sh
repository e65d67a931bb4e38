#!/bin/bash
# The product-level BWA index pipeline (reference README "Generating an
# index for BWA", SURVEY.md section 3.5) using bwtb3m end to end.
#
# Usage: examples/bwa_index_pipeline.sh ref.fa [workdir]
set -euo pipefail
FA=${1:?usage: bwa_index_pipeline.sh ref.fa [workdir]}
WORK=${2:-$(mktemp -d)}
mkdir -p "$WORK"
BIN="python -m bwtb3m"

# 1. FASTA -> 2-bit pac (BWA's own fa2pac if available; otherwise pack
#    with fagzToCompact4 and convert — here we use bwa when present)
if command -v bwa >/dev/null; then
    (cd "$WORK" && bwa fa2pac "$FA" ref)
    PAC="$WORK/ref.pac"
else
    # pure bwtb3m path: pack ACGT (N -> seeded random, recorded in meta)
    $BIN fagzToCompact4 "outputfilename=$WORK/ref.c4" "$FA"
    python - "$WORK" <<'PY'
import sys
from bwtb3m.io import compact
from bwtb3m.io.pac import write_pac
work = sys.argv[1]
sym, _bits = compact.read_compact(work + "/ref.c4")
write_pac(work + "/ref.pac", sym)
PY
    PAC="$WORK/ref.pac"
fi

# 2. BWT + sampled SA over the pacterm text (terminator = BWA's '$')
$BIN bwtb3m inputtype=pacterm mem=2G sasamplingrate=32 isasamplingrate=32 \
    "outputfilename=$PAC.bwt" "$PAC"

# 3. verify (total-correctness LF walk)
$BIN checkbwt inputtype=pacterm "$PAC" "$PAC.bwt"

# 4. rewrite into BWA's .bwt/.sa
$BIN bwtb3mtobwa "$PAC.bwt" "$WORK/ref.bwt" "$WORK/ref.sa"
echo "BWA index written to $WORK/ref.bwt + $WORK/ref.sa"
echo "finish with: bwa bwtupdate $WORK/ref.bwt"

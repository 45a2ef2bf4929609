#!/bin/bash
# One-command CI gate for ohpipeline_jax.
#
# Mirrors the reference's oncommit manifest discipline (the reference
# runs ~60 suites under valgrind per commit via one orchestrated list:
# /root/reference/oncommit.test:1-89 driven by jenkins_script.py:23-29,
# with slow suites split into nightly.test).  This repo's split:
#
#   oncommit (this script):
#     1. full pytest (conformance oracles auto-build from
#        /root/reference/thirdparty on first run)
#     2. native hostile-input fuzz/hardening suites under
#        AddressSanitizer (separate _build/asan tree + libasan preload
#        — the analogue of the reference's valgrind runs)
#     3. 8-device CPU-mesh multichip dryrun (__graft_entry__.dryrun_multichip)
#     4. bench.py --smoke (device decode parity + metric line)
#   on a GPU (run manually):
#     python chip_smoke.py       (the served path at real size, one card)
#     python chip_smoke.py --multichip (the mesh path, four cards)
#
# Writes one machine-readable verdict to CI_GATE.json, a local artifact
# (gitignored).  Exit 0 iff every stage passed.
set -u
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=cpu
export XLA_FLAGS="${XLA_FLAGS:-} --xla_force_host_platform_device_count=8"
OUT=CI_GATE.json
declare -A STAGE

run_stage() {
  local name="$1"; shift
  local t0=$(date +%s)
  echo "=== ci: $name ==="
  if "$@" > /tmp/ci_${name}.log 2>&1; then
    STAGE[$name]="pass"
  else
    STAGE[$name]="FAIL"
    tail -30 /tmp/ci_${name}.log
  fi
  echo "--- $name: ${STAGE[$name]} ($(( $(date +%s) - t0 ))s)"
}

run_stage pytest python -m pytest tests/ -x -q

ASAN_SO=$(ls /usr/lib/x86_64-linux-gnu/libasan.so.* 2>/dev/null | head -1)
if [ -n "$ASAN_SO" ]; then
  # -k filter: the *_python_fallback_matches_native tests dispatch jax
  # device programs, and jaxlib's bundled C++ runtime trips ASAN's
  # __cxa_throw interceptor CHECK (asan_interceptors.cpp:320) — an
  # interpreter-environment incompatibility, not a finding.  Those
  # parity tests run uninstrumented in the pytest stage; the ASAN stage
  # keeps every hostile-input fuzz path of the native cores.
  run_stage asan_fuzz env LD_PRELOAD="$ASAN_SO" OHP_NATIVE_ASAN=1 \
      ASAN_OPTIONS=detect_leaks=0 \
      python -m pytest tests/test_native_fuzz_codecs.py \
                       tests/test_native_hardening.py -x -q \
                       -k "not python_fallback"
else
  STAGE[asan_fuzz]="skip(no libasan)"
fi

run_stage dryrun python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"
run_stage smoke python bench.py --smoke

python - "$OUT" <<EOF
import json, sys, time
stages = {$(for k in "${!STAGE[@]}"; do printf '"%s": "%s",' "$k" "${STAGE[$k]}"; done)}
ok = all(v == "pass" or v.startswith("skip") for v in stages.values())
json.dump({"gate": "oncommit", "ok": ok, "stages": stages,
           "gpu": ["python chip_smoke.py",
                   "python chip_smoke.py --multichip"]},
          open(sys.argv[1], "w"), indent=1)
print(json.dumps({"ci_gate_ok": ok, "stages": stages}))
EOF
for v in "${STAGE[@]}"; do [ "$v" = "FAIL" ] && exit 1; done
exit 0

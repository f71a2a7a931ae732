// Warm-window measurement substrate — THE single implementation of the
// sample-hygiene rules every adaptive tuner in this codebase follows.
//
// Three independent tuners grew the same hygiene by copy-paste (the
// CMA/TCP router's RecordRouteSample, the lane autotuner's
// RecordLaneSample, and the Python-side planner's window accounting),
// and each could drift from the others silently. The rules live here
// once; the router and lane tuner hold WarmStat cells and call
// FoldWarmSample; the Python mirror (ddstore_tpu/sched/measure.py)
// implements the identical contract for host-side sample sources and is
// parity-tested against this file's semantics (tests/test_sched.py).
//
// The contract, in fold order:
//   1. DIAL-TAINT DISCARD: a window that included a connection dial
//      timed the handshake, not the transport. While the cell has no
//      clean sample yet it is discarded — bounded by a caller-scoped
//      skip budget (kWarmMaxColdSkips): a peer set that redials every
//      window must not pin collection forever; past the budget the
//      tainted number beats having none.
//   2. FIRST-WINDOW (WARM-UP) DISCARD: each cell's first surviving
//      window timed the path WAKING (TCP slow-start restart, sleeping
//      pool threads), not running; it is consumed to warm the cell and
//      its value dropped.
//   3. PAIRED-PROBE DISCARD: steady-state probes of a non-preferred
//      path come as consecutive pairs; the first only re-warms the idle
//      path. The caller arms a discard flag for it; the fold consumes
//      the flag and drops that one sample.
//   4. EWMA FOLD: surviving samples fold at kWarmEwmaAlpha (first
//      sample seeds the estimate outright).

#ifndef DDSTORE_TPU_MEASURE_H_
#define DDSTORE_TPU_MEASURE_H_

namespace dds {

// Clean samples a cell needs before a verdict may be read off it (one
// sample is a wake-up measurement, not a comparison). Shared by the
// router's collection phase, the lane tuner's per-level ramp, and the
// planner's confidence gate.
constexpr int kWarmMinSamples = 2;
// Dial-tainted discards allowed per tuner before tainted numbers are
// accepted anyway (see rule 1).
constexpr int kWarmMaxColdSkips = 4;
// EWMA smoothing: new estimate = alpha * old + (1 - alpha) * sample.
constexpr double kWarmEwmaAlpha = 0.5;

// One warm-window estimator cell: a (traffic class, knob value) pair's
// throughput estimate plus its hygiene state.
struct WarmStat {
  double ewma = 0.0;  // bytes/s estimate; 0 = no clean sample yet
  int n = 0;          // clean samples folded
  bool warmed = false;  // warm-up window consumed (rule 2)

  void Reset() {
    ewma = 0.0;
    n = 0;
    warmed = false;
  }
};

// Fold outcome, for observability/tests (callers mostly ignore it).
enum class WarmFold : int {
  kFolded = 0,      // sample entered the EWMA
  kDropCold = 1,    // rule 1: dial-tainted, skip budget charged
  kDropWarmup = 2,  // rule 2: consumed as the cell's warm-up
  kDropProbe = 3,   // rule 3: consumed the armed probe-pair discard
};

// Fold one measured window into `s` under the hygiene contract above.
// `cold` marks a window that included a dial; `cold_skips` is the
// CALLER-scoped discard budget rule 1 charges (shared across a tuner's
// cells — per-tuner, not per-cell, so a flapping peer can't spend the
// budget once per level); nullptr opts out of rule 1. `discard_flag`,
// when non-null and set, is rule 3's armed one-shot discard; nullptr
// (or unset) opts out.
inline WarmFold FoldWarmSample(WarmStat& s, double value, bool cold,
                               int* cold_skips, bool* discard_flag) {
  if (cold && s.n == 0 && cold_skips &&
      *cold_skips < kWarmMaxColdSkips) {
    ++*cold_skips;
    return WarmFold::kDropCold;
  }
  if (!s.warmed) {
    s.warmed = true;
    return WarmFold::kDropWarmup;
  }
  if (discard_flag && *discard_flag) {
    *discard_flag = false;
    return WarmFold::kDropProbe;
  }
  s.ewma = s.ewma == 0.0
               ? value
               : kWarmEwmaAlpha * s.ewma + (1.0 - kWarmEwmaAlpha) * value;
  ++s.n;
  return WarmFold::kFolded;
}

}  // namespace dds

#endif  // DDSTORE_TPU_MEASURE_H_

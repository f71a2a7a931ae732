// Machine-readable lock specifications for the native layer.
//
// The concurrency invariants of this codebase ("never hold a data-lane
// mutex during Ping", "no getenv under async_mu_ on the hot path",
// "health thread declared last = joined first") used to live only in
// CHANGES.md prose. These macros turn them into annotations that
// (a) the repo-native static analyzer (ddstore_tpu/analysis — lexer +
// per-function lock-state tracker, runs as a tier-1 test) consumes as
// ground truth, and (b) map onto clang's Thread Safety Analysis
// attributes when a clang build opts in. Under this container's gcc 10
// (and by default everywhere) they expand to nothing — zero code-gen
// or ABI effect.
//
// Vocabulary (annotation arguments name mutexes; the analyzer also
// accepts qualified inner-struct names like `Conn::mu` that are not
// valid C++ expressions, which is why the clang mapping is opt-in via
// -DDDS_USE_CLANG_THREAD_SAFETY rather than automatic):
//
//   DDS_GUARDED_BY(m)        field: reads/writes require m held.
//   DDS_REQUIRES(...)        function: caller must hold these mutexes
//                            (the analyzer checks call sites AND treats
//                            them as held inside the body).
//   DDS_EXCLUDES(...)        function: must not acquire (or hold) these
//                            — e.g. Ping vs the data-lane mutexes.
//   DDS_ACQUIRED_BEFORE(...) mutex decl: declared lock-order edges,
//                            seeding the analyzer's global
//                            acquisition-order graph (observed lexical
//                            nesting adds the rest; cycles fail lint).
//   DDS_NO_BLOCKING          mutex decl: no blocking call (connect,
//                            poll, read/recv, sleep_for, Wait, getenv,
//                            ...) may run while this mutex is held —
//                            the "hot-path mutex" marker.
//   DDS_DESTROYED_BEFORE(m)  member decl: this member's destructor must
//                            run before m's, i.e. it must be DECLARED
//                            AFTER m (reverse destruction order). Pins
//                            "health thread declared last = joined
//                            first"-style teardown contracts.
//
// Adding a new mutex? Annotate its guarded fields and lock-taking
// methods here-style, then run `make lint` — see README "Static
// analysis".

#ifndef DDSTORE_TPU_THREAD_ANNOTATIONS_H_
#define DDSTORE_TPU_THREAD_ANNOTATIONS_H_

#if defined(DDS_USE_CLANG_THREAD_SAFETY) && defined(__clang__)
// Clang Thread Safety Analysis mapping. Opt-in: some annotation
// arguments in this tree (qualified inner-struct mutex names, parameter
// members) are analyzer-vocabulary, not valid capability expressions,
// so the default build must not feed them to the compiler.
#define DDS_GUARDED_BY(x) __attribute__((guarded_by(x)))
#define DDS_REQUIRES(...) __attribute__((exclusive_locks_required(__VA_ARGS__)))
#define DDS_EXCLUDES(...) __attribute__((locks_excluded(__VA_ARGS__)))
#define DDS_ACQUIRED_BEFORE(...) __attribute__((acquired_before(__VA_ARGS__)))
#else
#define DDS_GUARDED_BY(x)
#define DDS_REQUIRES(...)
#define DDS_EXCLUDES(...)
#define DDS_ACQUIRED_BEFORE(...)
#endif

// Analyzer-only markers (no clang TSA equivalent).
#define DDS_NO_BLOCKING
#define DDS_DESTROYED_BEFORE(x)

#endif  // DDSTORE_TPU_THREAD_ANNOTATIONS_H_

// Native smoke test: the store core used from pure C++, no Python, no JAX.
// Parity with the reference's test/demo.cxx:7-41 (each MPI rank registers a
// 2x2 shard and reads a neighbor's row), but ranks here are threads in one
// process on the in-process transport, plus a second pass over the TCP
// transport on localhost — covering both backends the way the reference's
// demo covers libfabric.
//
// Build: `python -m ddstore_tpu_torch._build --demo` (build_demo in
// _build.py) prints the executable's path. Run: dds_demo [world]
// Exit code 0 iff every cross-rank read returns the owner's rank stamp.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "local_transport.h"
#include "store.h"
#include "tcp_transport.h"

namespace {

constexpr int64_t kRows = 4;
constexpr int64_t kDisp = 8;

// Rank-stamp oracle (reference test/demo.py:37,54-56): rank r's shard holds
// rows filled with (r+1); a fetched row must equal its owner's stamp.
int RunRank(dds::Store* store, int rank, int world) {
  std::vector<double> shard(kRows * kDisp, static_cast<double>(rank + 1));
  std::vector<int64_t> all_nrows(world, kRows);
  int rc = store->Add("var", shard.data(), kRows, kDisp, sizeof(double),
                      all_nrows.data(), /*copy=*/true);
  if (rc != dds::kOk) {
    std::fprintf(stderr, "rank %d: add failed: %s\n", rank,
                 dds::ErrorString(rc));
    return 1;
  }
  rc = store->Barrier(1000);
  if (rc != dds::kOk) return 1;

  int failures = 0;
  std::vector<double> buf(kDisp);
  for (int step = 1; step < world; ++step) {
    int peer = (rank + step) % world;
    int64_t row = peer * kRows + (rank % kRows);
    rc = store->Get("var", buf.data(), row, 1);
    if (rc != dds::kOk) {
      std::fprintf(stderr, "rank %d: get(%lld) failed: %s\n", rank,
                   static_cast<long long>(row), dds::ErrorString(rc));
      ++failures;
      continue;
    }
    for (int64_t j = 0; j < kDisp; ++j) {
      if (buf[j] != static_cast<double>(peer + 1)) {
        std::fprintf(stderr, "rank %d: row %lld value %f != %d\n", rank,
                     static_cast<long long>(row), buf[j], peer + 1);
        ++failures;
        break;
      }
    }
  }
  // Batched path across all peers at once.
  std::vector<int64_t> idx;
  for (int p = 0; p < world; ++p) idx.push_back(p * kRows);
  std::vector<double> batch(idx.size() * kDisp);
  rc = store->GetBatch("var", batch.data(), idx.data(),
                       static_cast<int64_t>(idx.size()));
  if (rc != dds::kOk) ++failures;
  for (size_t i = 0; i < idx.size(); ++i)
    if (batch[i * kDisp] != static_cast<double>(i + 1)) ++failures;

  store->Barrier(2000);
  return failures;
}

int RunLocal(int world) {
  std::vector<std::unique_ptr<dds::Store>> stores(world);
  for (int r = 0; r < world; ++r) {
    auto group = dds::LocalGroup::GetOrCreate("demo", world);
    auto t = std::make_unique<dds::LocalTransport>(group, r);
    dds::LocalTransport* raw = t.get();
    stores[r] = std::make_unique<dds::Store>(std::move(t));
    raw->Attach(stores[r].get());
  }
  std::vector<std::thread> threads;
  std::vector<int> fails(world, 0);
  for (int r = 0; r < world; ++r)
    threads.emplace_back(
        [&, r] { fails[r] = RunRank(stores[r].get(), r, world); });
  for (auto& t : threads) t.join();
  dds::LocalGroup::Release("demo");
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

int RunTcp(int world) {
  std::vector<std::unique_ptr<dds::Store>> stores(world);
  std::vector<dds::TcpTransport*> raws(world);
  std::vector<int> ports(world);
  for (int r = 0; r < world; ++r) {
    auto t = std::make_unique<dds::TcpTransport>(r, world, 0);
    raws[r] = t.get();
    ports[r] = t->server_port();
    stores[r] = std::make_unique<dds::Store>(std::move(t));
    raws[r]->Attach(stores[r].get());
  }
  std::vector<std::string> hosts(world, "127.0.0.1");
  for (int r = 0; r < world; ++r) raws[r]->SetPeers(hosts, ports);
  std::vector<std::thread> threads;
  std::vector<int> fails(world, 0);
  for (int r = 0; r < world; ++r)
    threads.emplace_back(
        [&, r] { fails[r] = RunRank(stores[r].get(), r, world); });
  for (auto& t : threads) t.join();
  int total = 0;
  for (int f : fails) total += f;
  return total;
}

}  // namespace

int main(int argc, char** argv) {
  int world = argc > 1 ? std::atoi(argv[1]) : 4;
  int local_fails = RunLocal(world);
  std::printf("local transport: %s\n", local_fails ? "FAIL" : "ok");
  int tcp_fails = RunTcp(world);
  std::printf("tcp transport:   %s\n", tcp_fails ? "FAIL" : "ok");
  return (local_fails || tcp_fails) ? 1 : 0;
}

// qba_native — C++ host runtime for the QBA protocol (the port's copy of
// the JAX package's, qba_tpu/native/src/qba_native.cc, reading the draws
// in the draws kernel's layout).
//
// The reference delegates its entire host runtime to native dependencies:
// an MPI C library for transport (tfg.py:199-263,310-363) and qsimov's C
// core for circuit simulation (tfg.py:68-84).  This runtime is the
// host-side message level: a tagged PvL wire codec (the send_pvl/recv_pvl
// format, tfg.py:199-263) and a message-level protocol engine that runs a
// full trial over per-party mailboxes (tfg.py:166-363).
//
// Randomness is pre-sampled by the caller (honesty mask, particle lists,
// commander orders, every round's attack draws) so the engine is a
// deterministic function, bit-compatible with the port's other backends
// for the same key tree; tests/test_torch_backends.py holds it against
// them.
//
// Build: g++ -O2 -std=c++17 -Wall -Wextra -fPIC -shared -pthread
// (qba_tpu_torch/native/__init__.py builds it at first use).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <set>
#include <thread>
#include <vector>

namespace {

using Tuple = std::vector<int32_t>;

// ---------------------------------------------------------------------------
// Consistency predicate (tfg.py:87-98): (1) all tuples the same length,
// (2) every element in [0, w] and != v, (3) every pair of tuples differs
// at every index.  Empty L is consistent.
bool consistent(int32_t v, const std::set<Tuple>& L, int32_t w) {
  if (L.empty()) return true;
  const size_t n = L.begin()->size();
  for (const Tuple& t : L) {
    if (t.size() != n) return false;
    for (int32_t x : t) {
      if (x < 0 || x > w || x == v) return false;
    }
  }
  for (auto a = L.begin(); a != L.end(); ++a) {
    for (auto b = std::next(a); b != L.end(); ++b) {
      for (size_t k = 0; k < n; ++k) {
        if ((*a)[k] == (*b)[k]) return false;
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// PvL wire codec.  Flat int32 layout mirroring the reference's tag
// sequence (tfg.py:199-263): |P|, P..., v, |L|, then per tuple: len,
// elements.  Returns the number of int32 words written, or -1 on
// insufficient capacity.
int encode_pvl(const std::vector<int32_t>& p, int32_t v,
               const std::set<Tuple>& L, int32_t* out, int cap) {
  std::vector<int32_t> buf;
  buf.push_back(static_cast<int32_t>(p.size()));
  buf.insert(buf.end(), p.begin(), p.end());
  buf.push_back(v);
  buf.push_back(static_cast<int32_t>(L.size()));
  for (const Tuple& t : L) {
    buf.push_back(static_cast<int32_t>(t.size()));
    buf.insert(buf.end(), t.begin(), t.end());
  }
  if (static_cast<int>(buf.size()) > cap) return -1;
  std::copy(buf.begin(), buf.end(), out);
  return static_cast<int>(buf.size());
}

// Returns words consumed, or -1 on a malformed buffer.
int decode_pvl(const int32_t* buf, int len, std::vector<int32_t>* p,
               int32_t* v, std::set<Tuple>* L) {
  int i = 0;
  if (i >= len) return -1;
  int32_t np = buf[i++];
  if (np < 0 || i + np > len) return -1;
  p->assign(buf + i, buf + i + np);
  i += np;
  if (i >= len) return -1;
  *v = buf[i++];
  if (i >= len) return -1;
  int32_t nt = buf[i++];
  if (nt < 0) return -1;
  L->clear();
  for (int32_t t = 0; t < nt; ++t) {
    if (i >= len) return -1;
    int32_t tl = buf[i++];
    if (tl < 0 || i + tl > len) return -1;
    L->insert(Tuple(buf + i, buf + i + tl));
    i += tl;
  }
  return i;
}

struct Packet {
  std::vector<int32_t> p;
  int32_t v;
  std::set<Tuple> L;
};

}  // namespace

extern "C" {

// consistent() over a flat [n_tuples, max_len] tuple matrix with per-tuple
// lengths; exposed for differential tests against the Python/JAX versions.
int qba_consistent(int32_t v, const int32_t* tuples, const int32_t* lens,
                   int n_tuples, int max_len, int32_t w) {
  std::set<Tuple> L;
  for (int t = 0; t < n_tuples; ++t) {
    L.insert(Tuple(tuples + t * max_len, tuples + t * max_len + lens[t]));
  }
  return consistent(v, L, w) ? 1 : 0;
}

int qba_encode_pvl(const int32_t* p, int np, int32_t v, const int32_t* tuples,
                   const int32_t* lens, int n_tuples, int max_len,
                   int32_t* out, int cap) {
  std::vector<int32_t> pv(p, p + np);
  std::set<Tuple> L;
  for (int t = 0; t < n_tuples; ++t) {
    L.insert(Tuple(tuples + t * max_len, tuples + t * max_len + lens[t]));
  }
  return encode_pvl(pv, v, L, out, cap);
}

// Decode into flat buffers: p_out (cap np_cap), tuple matrix
// [nt_cap, max_len] + lens.  Writes (np, v, nt) into header_out[0..2].
// Returns words consumed or -1.
int qba_decode_pvl(const int32_t* buf, int len, int32_t* p_out, int np_cap,
                   int32_t* tuples_out, int32_t* lens_out, int nt_cap,
                   int max_len, int32_t* header_out) {
  std::vector<int32_t> p;
  int32_t v;
  std::set<Tuple> L;
  int used = decode_pvl(buf, len, &p, &v, &L);
  if (used < 0) return -1;
  if (static_cast<int>(p.size()) > np_cap ||
      static_cast<int>(L.size()) > nt_cap)
    return -1;
  std::copy(p.begin(), p.end(), p_out);
  int t = 0;
  for (const Tuple& tup : L) {
    if (static_cast<int>(tup.size()) > max_len) return -1;
    lens_out[t] = static_cast<int32_t>(tup.size());
    std::copy(tup.begin(), tup.end(), tuples_out + t * max_len);
    ++t;
  }
  header_out[0] = static_cast<int32_t>(p.size());
  header_out[1] = v;
  header_out[2] = static_cast<int32_t>(L.size());
  return used;
}

// Full message-level trial (tfg.py:166-363) over pre-sampled randomness.
//
//   honest   : uint8[n_parties+1], rank-indexed (rank 0 = QSD)
//   lists    : int32[(n_parties+1) * size_l], row-major
//   v_sent   : int32[n_lieu] per-lieutenant commander order (equivocation
//              already applied, tfg.py:169-181)
//   attack, rand_v, late : uint8[n_rounds * n_cells * n_lieu] each, the
//              draws kernel's packet-major layout: entry
//              ((round-1) * n_cells + sender*slots+slot) * n_lieu +
//              receiver (n_cells = n_lieu * slots; the
//              sample_attacks_round layout, rounds stacked).
//              `attack` is the effective edit bitmask (bit0 drop, bit1
//              forge-v, bit2 clear-P, bit3 clear-L, bit4 forge-P: the
//              fabricated all-positions evidence mask, applied after the
//              clears so forgery wins) with the configured attack scope
//              and strategy already folded in, so this engine is
//              scope- and strategy-agnostic; `late` = 1 -> the delivery is silently
//              late: under racy_defer=0 the delivery is silently lost
//              before any corruption; under racy_defer=1 the corrupted
//              packet is instead delivered at the start of the NEXT
//              round's drain, where the evidence-length check
//              necessarily rejects it — the reference's actual race
//              mechanism (the barrier-race model of
//              docs/DIVERGENCES.md D1; late is all 0 under
//              delivery="sync")
//   decisions_out : int32[n_parties] (index 0 = commander)
//   vi_out   : uint8[n_lieu * w] accepted-set masks
//   flags_out: int32[2] = {success, overflow}
//   trace_out/trace_cap/trace_len : optional protocol event trail — the
//              in-engine analog of the reference's mpi_print sites
//              (tfg.py:190,203,229,275-284,294).  When trace_out is
//              non-null, fixed 7-int32 records {kind, round, sender_rank,
//              recv_rank, v, a, b} are appended (capacity trace_cap
//              records; excess events are dropped and *trace_len saturates
//              at trace_cap so the caller can detect truncation):
//                kind 1 step2 send       (a=|P|, b=0)          tfg.py:203
//                kind 2 step3a receive   (a=accepted, b=reason) tfg.py:190
//                kind 3 racy late loss                      DIVERGENCES D1
//                kind 4 attack           (a=edit bitmask)  tfg.py:275-284
//                kind 5 round receive    (a=accepted, b=reason) tfg.py:294
//                kind 6 rebroadcast      (a=|P|, b=|L|)        tfg.py:229
//                kind 9 deferred receive (a=accepted, b=reason) — a
//                       kind-5 delivery that arrived one round late
//                       (racy_defer)                      DIVERGENCES D1
//                kind 10 late defer      — the packet was queued for
//                       the next round                    DIVERGENCES D1
//                kind 7 vi snapshot header (a=|Vi|), followed by |Vi|
//                       kind 8 records {8, round, rank, 0, value, 0, 0}
//                       — value list form, exact for any w
//              reason codes: 0 accepted, 1 inconsistent, 2 duplicate-v,
//              3 wrong-evidence-len (the lieu_receive condition order,
//              tfg.py:294).
//
// Packets move between parties through the PvL codec (encode on send,
// decode on delivery) — the in-process analog of the reference's tagged
// MPI transport.  Returns 0, or -1 on a codec capacity/format error.
int qba_run_trial(int n_parties, int size_l, int n_dishonest, int32_t w,
                  int slots, int racy_defer, const uint8_t* honest,
                  const int32_t* lists,
                  const int32_t* v_sent, int32_t v_comm,
                  const uint8_t* attack, const uint8_t* rand_v,
                  const uint8_t* late, int32_t* decisions_out,
                  uint8_t* vi_out, int32_t* flags_out,
                  int32_t* trace_out, int32_t trace_cap,
                  int32_t* trace_len) {
  const int n_lieu = n_parties - 1;
  const int n_rounds = n_dishonest + 1;
  const int max_l = n_dishonest + 2;
  const int cap = 3 + size_l + max_l * (1 + size_l);

  int32_t n_trace = 0;
  auto trace = [&](int32_t kind, int32_t rnd, int32_t sender, int32_t recv,
                   int32_t v, int32_t a, int32_t b) {
    if (trace_out == nullptr || n_trace >= trace_cap) return;
    int32_t* rec = trace_out + static_cast<size_t>(n_trace) * 7;
    rec[0] = kind; rec[1] = rnd; rec[2] = sender; rec[3] = recv;
    rec[4] = v; rec[5] = a; rec[6] = b;
    ++n_trace;
  };

  auto list_row = [&](int rank) { return lists + rank * size_l; };

  // Step 1b (tfg.py:325-328): positions where the QSD copy differs from
  // the commander's own list are exactly the Q-correlated ones.
  std::vector<int32_t> isq;
  for (int k = 0; k < size_l; ++k) {
    if (list_row(0)[k] != list_row(1)[k]) isq.push_back(k);
  }

  std::vector<std::set<int32_t>> vi(n_lieu);
  bool overflow = false;

  // Mailboxes hold encoded packets; slot index = append order (the dense
  // mailbox tensor numbering shared with the JAX engine).
  using Wire = std::vector<int32_t>;
  std::vector<std::vector<Wire>> mailbox(n_lieu);

  auto own_sublist = [&](int lieu, const std::vector<int32_t>& p) {
    Tuple t;
    t.reserve(p.size());
    for (int32_t j : p) t.push_back(list_row(lieu + 2)[j]);
    return t;
  };

  auto push = [&](std::vector<Wire>* box, const Packet& pk) -> int {
    Wire wire(cap);
    int n = encode_pvl(pk.p, pk.v, pk.L, wire.data(), cap);
    if (n < 0) return -1;
    wire.resize(n);
    box->push_back(std::move(wire));
    return 0;
  };

  // Step 2 + 3a (tfg.py:166-196).
  for (int i = 0; i < n_lieu; ++i) {
    Packet pk;
    pk.v = v_sent[i];
    for (int32_t k : isq) {
      if (list_row(1)[k] == pk.v) pk.p.push_back(k);
    }
    trace(1, 0, 1, i + 2, pk.v, static_cast<int32_t>(pk.p.size()), 0);
    pk.L.insert(own_sublist(i, pk.p));
    const bool ok3a = consistent(pk.v, pk.L, w);
    trace(2, 0, 1, i + 2, pk.v, ok3a ? 1 : 0, ok3a ? 0 : 1);
    if (ok3a) {
      vi[i].insert(pk.v);
      if (push(&mailbox[i], pk) < 0) return -1;
    }
  }

  // Step 3b (tfg.py:337-348): synchronous rounds.  Under racy_defer,
  // late packets carry over one round (corrupted with the ORIGINAL
  // round's draws — the reference corrupts at send time, before the
  // race) and are drained first, where the evidence-length check
  // necessarily rejects them (docs/DIVERGENCES.md D1).
  struct Late { int sender_rank; Packet pk; };
  std::vector<std::vector<Late>> deferred(n_lieu);
  for (int rnd = 1; rnd <= n_rounds; ++rnd) {
    std::vector<std::vector<Wire>> out(n_lieu);
    std::vector<std::vector<Late>> next_deferred(n_lieu);
    // lieu_receive (tfg.py:289-300), shared by deferred + fresh traffic.
    auto lieu_receive = [&](int recv, int sender_rank, Packet& pk,
                            bool was_deferred) -> int {
      pk.L.insert(own_sublist(recv, pk.p));
      int32_t reason;
      if (!consistent(pk.v, pk.L, w)) reason = 1;
      else if (vi[recv].count(pk.v)) reason = 2;
      else if (static_cast<int>(pk.L.size()) != rnd + 1) reason = 3;
      else reason = 0;
      trace(was_deferred ? 9 : 5, rnd, sender_rank, recv + 2, pk.v,
            reason == 0 ? 1 : 0, reason);
      if (reason == 0) {
        vi[recv].insert(pk.v);
        if (rnd <= n_dishonest) {
          if (static_cast<int>(out[recv].size()) < slots) {
            trace(6, rnd, recv + 2, 0, pk.v,
                  static_cast<int32_t>(pk.p.size()),
                  static_cast<int32_t>(pk.L.size()));
            if (push(&out[recv], pk) < 0) return -1;
          } else {
            overflow = true;
          }
        }
      }
      return 0;
    };
    // Deferred arrivals from the previous round drain first (they were
    // in the queue before this round's traffic; deterministic order).
    for (int recv = 0; recv < n_lieu; ++recv) {
      for (Late& d : deferred[recv]) {
        if (lieu_receive(recv, d.sender_rank, d.pk, true) < 0) return -1;
      }
    }
    for (int recv = 0; recv < n_lieu; ++recv) {
      for (int sender = 0; sender < n_lieu; ++sender) {
        int n_slots = std::min<int>(slots, mailbox[sender].size());
        for (int slot = 0; slot < n_slots; ++slot) {
          if (sender == recv) continue;
          const Wire& wire = mailbox[sender][slot];
          Packet pk;
          if (decode_pvl(wire.data(), static_cast<int>(wire.size()), &pk.p,
                         &pk.v, &pk.L) < 0)
            return -1;
          const size_t at =
              (static_cast<size_t>(rnd - 1) * n_lieu * slots +
               sender * slots + slot) *
                  n_lieu +
              recv;
          const int32_t bits = attack[at];
          if (late[at] && !racy_defer) {  // racy late loss (DIVERGENCES.md D1)
            trace(3, rnd, sender + 2, recv + 2, 0, 0, 0);
            continue;
          }
          if (!honest[sender + 2]) {  // tfg.py:271-284
            trace(4, rnd, sender + 2, recv + 2, 0, bits, 0);
            if (bits & 1) continue;          // drop
            if (bits & 2) pk.v = rand_v[at]; // forged v
            if (bits & 4) pk.p.clear();      // clear P
            if (bits & 8) pk.L.clear();      // clear L
            if (bits & 16) {                 // forge-P: full mask wins
              pk.p.resize(size_l);
              for (int32_t k = 0; k < size_l; ++k) pk.p[k] = k;
            }
          }
          if (late[at]) {  // racy_defer: queue for the next round's drain
            trace(10, rnd, sender + 2, recv + 2, 0, 0, 0);
            next_deferred[recv].push_back(Late{sender + 2, std::move(pk)});
            continue;
          }
          if (lieu_receive(recv, sender + 2, pk, false) < 0) return -1;
        }
      }
    }
    for (int i = 0; i < n_lieu; ++i) {
      trace(7, rnd, i + 2, 0, 0, static_cast<int32_t>(vi[i].size()), 0);
      for (int32_t x : vi[i]) trace(8, rnd, i + 2, 0, x, 0, 0);
    }
    mailbox = std::move(out);
    deferred = std::move(next_deferred);
  }

  // Decision + verdict (tfg.py:303-306,351-363; empty-Vi sentinel = w,
  // docs/DIVERGENCES.md D2).
  decisions_out[0] = v_comm;
  for (int i = 0; i < n_lieu; ++i) {
    decisions_out[i + 1] = vi[i].empty() ? w : *vi[i].begin();
    for (int32_t x = 0; x < w; ++x) {
      vi_out[i * w + x] = vi[i].count(x) ? 1 : 0;
    }
  }
  std::set<int32_t> filtered;
  for (int i = 0; i < n_parties; ++i) {
    if (honest[i + 1]) filtered.insert(decisions_out[i]);
  }
  flags_out[0] = filtered.size() == 1 ? 1 : 0;
  flags_out[1] = overflow ? 1 : 0;
  if (trace_len) *trace_len = n_trace;
  return 0;
}

// Batched Monte-Carlo executor: runs n_trials independent trials across a
// host thread pool (work-stealing via an atomic cursor).  qba_run_trial is
// a pure function of its per-trial inputs, so trials parallelize with no
// shared state beyond the cursor.  All arrays are the single-trial layouts
// stacked along a leading n_trials axis; v_comm becomes int32[n_trials].
//
//   n_threads <= 0 -> std::thread::hardware_concurrency().
//
// Returns 0, or one failing trial's nonzero error code (the first store
// wins; which trial that is depends on thread scheduling).
int qba_run_trials(int n_trials, int n_threads, int n_parties, int size_l,
                   int n_dishonest, int32_t w, int slots, int racy_defer,
                   const uint8_t* honest, const int32_t* lists,
                   const int32_t* v_sent, const int32_t* v_comm,
                   const uint8_t* attack, const uint8_t* rand_v,
                   const uint8_t* late, int32_t* decisions_out,
                   uint8_t* vi_out, int32_t* flags_out) {
  const int n_lieu = n_parties - 1;
  const int n_rounds = n_dishonest + 1;
  const size_t honest_s = static_cast<size_t>(n_parties) + 1;
  const size_t lists_s = honest_s * size_l;
  const size_t vsent_s = n_lieu;
  const size_t att_s = static_cast<size_t>(n_rounds) * n_lieu * n_lieu *
                       slots;
  const size_t dec_s = n_parties;
  const size_t vi_s = static_cast<size_t>(n_lieu) * w;

  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min(n_threads, n_trials);

  std::atomic<int> cursor(0);
  std::atomic<int> rc(0);
  auto worker = [&]() {
    for (;;) {
      const int t = cursor.fetch_add(1);
      if (t >= n_trials) return;
      const int r = qba_run_trial(
          n_parties, size_l, n_dishonest, w, slots, racy_defer,
          honest + t * honest_s,
          lists + t * lists_s, v_sent + t * vsent_s, v_comm[t],
          attack + t * att_s, rand_v + t * att_s, late + t * att_s,
          decisions_out + t * dec_s, vi_out + t * vi_s,
          flags_out + t * 2, nullptr, 0, nullptr);
      if (r != 0) {
        int expected = 0;  // first error wins (deterministic reporting)
        rc.compare_exchange_strong(expected, r);
      }
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return rc.load();
}

}  // extern "C"

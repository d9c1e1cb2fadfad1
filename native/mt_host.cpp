// meryl_tpu native host substrate: byte-level sequence scanner.
//
// Native equivalent of the reference's dnaSeqFile/FASTA-FASTQ layer
// (interface documented in /root/repo/SURVEY.md §2.3; call sites
// /root/reference/src/meryl/merylInput.C:241-275).  This is the hot
// host loop feeding the device pipeline: it converts raw FASTA/FASTQ
// bytes into 2-bit base codes (A=00 C=01 T=10 G=11) with 0xFF
// separator/breaker codes, optionally homopolymer-compressing runs
// (merylInput.C:258-263 semantics), in a single streaming pass that
// may be split across arbitrary buffer boundaries.
//
// Build: make -C native   ->  libmeryl_host.so  (loaded via ctypes)

#include <cstdint>
#include <cstring>

namespace {

constexpr uint8_t SEP = 0xFF;

// char -> 2-bit code; 0xFF = invalid base (kmer breaker)
struct CodeTab {
  uint8_t t[256];
  constexpr CodeTab() : t() {
    for (int i = 0; i < 256; i++) t[i] = 0xFF;
    t['A'] = t['a'] = 0;
    t['C'] = t['c'] = 1;
    t['T'] = t['t'] = 2;
    t['G'] = t['g'] = 3;
  }
};
constexpr CodeTab kCode;

struct UpperTab {
  uint8_t t[256];
  constexpr UpperTab() : t() {
    for (int i = 0; i < 256; i++)
      t[i] = (i >= 'a' && i <= 'z') ? uint8_t(i - 32) : uint8_t(i);
  }
};
constexpr UpperTab kUpper;

enum Fmt : int32_t { F_UNKNOWN = 0, F_FASTA = 1, F_FASTQ = 2, F_RAW = 3 };
enum St : int32_t {
  S_START = 0,   // waiting for first non-space byte of a record
  S_HDR = 1,     // skipping a header line
  S_SEQ = 2,     // emitting sequence bases
  S_PLUS = 3,    // fastq: skipping the '+' line
  S_QUAL = 4,    // fastq: skipping quality (length-counted)
};

}  // namespace

extern "C" {

struct MtScanner {
  int32_t fmt;
  int32_t state;
  int64_t seqlen;     // bases in current record (for fastq qual length)
  int64_t quallen;
  uint8_t last_base;  // uppercased previous base char (hpc); 0 = none
  uint8_t emitted;    // emitted >=1 base since last separator
  uint8_t hpc;
  uint8_t bol;        // at beginning of a line
};

void mt_scanner_init(MtScanner* s, int32_t hpc) {
  std::memset(s, 0, sizeof(*s));
  s->hpc = (uint8_t)(hpc != 0);
  s->bol = 1;
}

// Scan n input bytes; write codes to out (capacity >= n + 1).
// Returns the number of codes written.  Call repeatedly with
// consecutive file chunks; state carries across calls.  After the last
// chunk call mt_scanner_finish to flush the trailing separator.
//
// Line-oriented: header/plus/qual lines are skipped with memchr, and
// sequence spans are bulk-converted through the code table (the inner
// loop vectorizes) — ~4x the byte-at-a-time state machine.
int64_t mt_scan(MtScanner* s, const uint8_t* in, int64_t n, uint8_t* out) {
  int64_t o = 0;
  int64_t i = 0;

  if (s->fmt == F_UNKNOWN) {
    while (i < n && (in[i] == '\n' || in[i] == '\r' || in[i] == ' ' ||
                     in[i] == '\t'))
      i++;
    if (i < n) {
      if (in[i] == '>')      { s->fmt = F_FASTA; s->state = S_HDR; i++; }
      else if (in[i] == '@') { s->fmt = F_FASTQ; s->state = S_HDR; i++; }
      else                   { s->fmt = F_RAW;   s->state = S_SEQ; }
      s->bol = 0;
    }
  }

  const uint8_t* code = kCode.t;
  const uint8_t* up = kUpper.t;

  while (i < n) {
    switch (s->state) {
      case S_HDR: {
        const uint8_t* nl =
            (const uint8_t*)memchr(in + i, '\n', (size_t)(n - i));
        if (nl == nullptr) { s->bol = 0; return o; }
        i = (nl - in) + 1;
        s->state = S_SEQ;
        s->seqlen = 0;
        s->last_base = 0;
        s->bol = 1;
        break;
      }

      case S_SEQ: {
        uint8_t c = in[i];
        if (s->fmt == F_FASTA && c == '>' && s->bol) {
          if (s->emitted) { out[o++] = SEP; s->emitted = 0; }
          s->state = S_HDR;
          break;
        }
        if (s->fmt == F_FASTQ && c == '+' && s->bol) {
          // end of (possibly multi-line) sequence; S_PLUS eats the line
          s->state = S_PLUS;
          break;
        }
        const uint8_t* nl =
            (const uint8_t*)memchr(in + i, '\n', (size_t)(n - i));
        int64_t end = nl ? (nl - in) : n;
        int64_t b = i, e = end;
        while (b < e && (in[e - 1] == '\r' || in[e - 1] == ' ' ||
                         in[e - 1] == '\t'))
          e--;
        if (e > b) {
          if (!s->hpc) {
            for (int64_t j = b; j < e; j++)   // vectorizes
              out[o + (j - b)] = code[in[j]];
            o += e - b;
          } else {
            uint8_t last = s->last_base;
            for (int64_t j = b; j < e; j++) {
              uint8_t u = up[in[j]];
              if (u != last) { out[o++] = code[in[j]]; last = u; }
            }
            s->last_base = last;
          }
          s->emitted = 1;
          s->seqlen += e - b;
        }
        if (nl == nullptr) { i = n; s->bol = 0; break; }
        i = end + 1;
        s->bol = 1;
        // FASTQ stays in S_SEQ: sequence may span multiple lines; the
        // record's '+' line (checked at bol above) ends it
        break;
      }

      case S_PLUS: {
        const uint8_t* nl =
            (const uint8_t*)memchr(in + i, '\n', (size_t)(n - i));
        if (nl == nullptr) { s->bol = 0; return o; }
        i = (nl - in) + 1;
        s->state = S_QUAL;
        s->quallen = 0;
        s->bol = 1;
        break;
      }

      case S_QUAL: {
        // consume exactly seqlen quality bytes (newlines and CR don't
        // count), so '@' at the start of a quality line can't be
        // mistaken for a header
        while (i < n && s->quallen < s->seqlen) {
          if (in[i] != '\n' && in[i] != '\r') s->quallen++;
          i++;
        }
        if (s->quallen >= s->seqlen) {
          if (s->emitted) { out[o++] = SEP; s->emitted = 0; }
          // skip to end of the quality line
          const uint8_t* nl =
              (const uint8_t*)memchr(in + i, '\n', (size_t)(n - i));
          if (nl == nullptr) {
            s->state = S_QUAL;  // stay; next call keeps skipping
            s->seqlen = 0;      // (quallen >= seqlen still holds)
            return o;
          }
          i = (nl - in) + 1;
          s->state = S_HDR;
          s->seqlen = 0;
          s->quallen = 0;
          s->last_base = 0;
          s->bol = 1;
        }
        break;
      }

      case S_START:
      default:
        i++;
        break;
    }
  }
  return o;
}

// Flush: emit a final separator if bases were emitted since the last.
int64_t mt_scanner_finish(MtScanner* s, uint8_t* out) {
  if (s->emitted) { s->emitted = 0; out[0] = SEP; return 1; }
  return 0;
}

// Linear-time merge of two sorted unique (hi, lo, count) runs, summing
// counts of equal kmers.  The host-side analog of the reference's
// batch-file merge (merylBlockWriter::finish) — replaces an O(n log n)
// numpy lexsort with one pass.  Returns the output length.
int64_t mt_merge2(const uint64_t* ha, const uint64_t* la,
                  const uint64_t* ca, int64_t na,
                  const uint64_t* hb, const uint64_t* lb,
                  const uint64_t* cb, int64_t nb,
                  uint64_t* ho, uint64_t* lo, uint64_t* co) {
  int64_t i = 0, j = 0, o = 0;
  // branchless main loop (random interleaving makes the branchy
  // version mispredict-bound at ~8M elem/s; cmovs run ~20x faster)
  while (i < na && j < nb) {
    uint64_t hai = ha[i], lai = la[i];
    uint64_t hbj = hb[j], lbj = lb[j];
    bool a_le = (hai < hbj) | ((hai == hbj) & (lai <= lbj));
    bool eq = (hai == hbj) & (lai == lbj);
    ho[o] = a_le ? hai : hbj;
    lo[o] = a_le ? lai : lbj;
    uint64_t cmain = a_le ? ca[i] : cb[j];
    uint64_t cother = a_le ? cb[j] : ca[i];
    co[o] = cmain + (eq ? cother : 0);
    i += a_le;
    j += (uint64_t)(!a_le) | (uint64_t)eq;
    o++;
  }
  while (i < na) { ho[o] = ha[i]; lo[o] = la[i]; co[o] = ca[i]; o++; i++; }
  while (j < nb) { ho[o] = hb[j]; lo[o] = lb[j]; co[o] = cb[j]; o++; j++; }
  return o;
}

// K-way merge of sorted unique (hi, lo, count-u64) runs, summing the
// counts of equal kmers — the single-pass replacement for a pairwise
// merge cascade: the cascade rewrites every entry log2(nruns) times
// (~12 passes at production run counts) while this touches memory
// once, with log2(nruns) in-cache winner-tree compares per entry.
// Runs are given as (offset, length) slices into flat arrays; callers
// thread-parallelize by kmer-range partitioning (each partition is an
// independent mt_merge_kway over sub-slices).
//
// (The reference's analog is the multi-file merge behind its 64-way
// DB slices, /root/reference/src/meryl/merylOp-nextMer.C:418-470 —
// there a per-slice lock-step streaming pull, here a loser-style
// tournament over run cursors.)
int64_t mt_merge_kway(const uint64_t* hi, const uint64_t* lo,
                      const uint64_t* ct,
                      const int64_t* offs, const int64_t* lens,
                      int64_t nruns,
                      uint64_t* ho, uint64_t* lo_out, uint64_t* co) {
  if (nruns <= 0) return 0;
  typedef unsigned __int128 u128;
  const u128 INF = ~(u128)0;
  int64_t K = 1;
  while (K < nruns) K <<= 1;
  // cursor index + cached current 128-bit key per run (keys live in a
  // contiguous array so the replay loop stays in cache); exhausted
  // runs hold INF (a real key is < 2^128-1: counts are nonzero, and a
  // kmer of all-ones pairs with hi=INF only for k=64 where the
  // canonical form forbids it — but guard anyway via cursor checks)
  int64_t* idx = new int64_t[K];
  u128* key = new u128[K];
  for (int64_t s = 0; s < K; s++) {
    idx[s] = 0;
    key[s] = (s < nruns && lens[s] > 0)
                 ? (((u128)hi[offs[s]] << 64) | lo[offs[s]])
                 : INF;
  }
  // loser tree: build a winner tree first, then store at each internal
  // node the child-subtree winner that LOST there; replay touches one
  // node per level with a branchless swap.  Ties break arbitrarily —
  // equal keys are summed on output, so emission order among equals
  // does not matter.
  int32_t* W = new int32_t[2 * K];
  for (int64_t s = 0; s < K; s++) W[K + s] = (int32_t)s;
  for (int64_t p = K - 1; p >= 1; p--) {
    int32_t a = W[2 * p], b = W[2 * p + 1];
    W[p] = key[a] <= key[b] ? a : b;
  }
  int32_t* loser = new int32_t[K];
  loser[0] = 0;  // unused
  for (int64_t p = 1; p < K; p++) {
    int32_t a = W[2 * p], b = W[2 * p + 1];
    loser[p] = (W[p] == a) ? b : a;
  }
  int32_t winner = W[1];
  delete[] W;

  int64_t o = -1;
  u128 prev = INF;
  while (true) {
    u128 wk = key[winner];
    if (wk == INF) break;  // every run exhausted
    int64_t s = winner;
    uint64_t c = ct[offs[s] + idx[s]];
    if (wk == prev) {
      co[o] += c;
    } else {
      ++o;
      ho[o] = (uint64_t)(wk >> 64);
      lo_out[o] = (uint64_t)wk;
      co[o] = c;
      prev = wk;
    }
    // advance the winner's cursor and replay its leaf-to-root path
    int64_t i = ++idx[s];
    u128 ck = (i < lens[s]) ? (((u128)hi[offs[s] + i] << 64) |
                               lo[offs[s] + i])
                            : INF;
    // prefetch the entry the NEXT win of this run will touch: cursor
    // streams miss DRAM once per cache line and the tournament is
    // latency-bound (the line arrives long before the run wins again)
    if (i + 8 < lens[s]) {
      __builtin_prefetch(&hi[offs[s] + i + 8]);
      __builtin_prefetch(&lo[offs[s] + i + 8]);
      __builtin_prefetch(&ct[offs[s] + i + 8]);
    }
    key[s] = ck;  // must precede replay: s may be stored as a loser
    int32_t cur = winner;
    for (int64_t p = (K + s) >> 1; p >= 1; p >>= 1) {
      int32_t l = loser[p];
      u128 lk = key[l];
      bool sw = lk < ck;  // cached loser beats the climber
      int32_t nl = sw ? cur : l;
      loser[p] = nl;
      cur = sw ? l : cur;
      ck = sw ? lk : ck;
    }
    winner = cur;
  }
  delete[] loser;
  delete[] key;
  delete[] idx;
  return o + 1;
}

// u64-key specialization of mt_merge_kway for the common k <= 32 case
// where every run's hi plane is one constant (the caller checks and
// fills the output hi itself): u64 compares emit single-instruction
// cmovs where the 128-bit path tends to branch, roughly doubling
// tournament throughput.  Key caveat shared with the generic path:
// exhausted runs are keyed UINT64_MAX, so a real key of UINT64_MAX
// would terminate early — impossible for kmer los with 2k < 64, and
// the caller routes k = 32 through the 128-bit path.
int64_t mt_merge_kway64(const uint64_t* lo, const uint64_t* ct,
                        const int64_t* offs, const int64_t* lens,
                        int64_t nruns,
                        uint64_t* lo_out, uint64_t* co) {
  if (nruns <= 0) return 0;
  const uint64_t INF = ~(uint64_t)0;
  int64_t K = 1;
  while (K < nruns) K <<= 1;
  int64_t* idx = new int64_t[K];
  uint64_t* key = new uint64_t[K];
  for (int64_t s = 0; s < K; s++) {
    idx[s] = 0;
    key[s] = (s < nruns && lens[s] > 0) ? lo[offs[s]] : INF;
  }
  int32_t* W = new int32_t[2 * K];
  for (int64_t s = 0; s < K; s++) W[K + s] = (int32_t)s;
  for (int64_t p = K - 1; p >= 1; p--) {
    int32_t a = W[2 * p], b = W[2 * p + 1];
    W[p] = key[a] <= key[b] ? a : b;
  }
  int32_t* loser = new int32_t[K];
  loser[0] = 0;
  for (int64_t p = 1; p < K; p++) {
    int32_t a = W[2 * p], b = W[2 * p + 1];
    loser[p] = (W[p] == a) ? b : a;
  }
  int32_t winner = W[1];
  delete[] W;

  int64_t o = -1;
  uint64_t prev = INF;
  while (true) {
    uint64_t wk = key[winner];
    if (wk == INF) break;
    int64_t s = winner;
    uint64_t c = ct[offs[s] + idx[s]];
    if (wk == prev) {
      co[o] += c;
    } else {
      ++o;
      lo_out[o] = wk;
      co[o] = c;
      prev = wk;
    }
    int64_t i = ++idx[s];
    uint64_t ck = (i < lens[s]) ? lo[offs[s] + i] : INF;
    if (i + 8 < lens[s]) {
      __builtin_prefetch(&lo[offs[s] + i + 8]);
      __builtin_prefetch(&ct[offs[s] + i + 8]);
    }
    key[s] = ck;
    int32_t cur = winner;
    for (int64_t p = (K + s) >> 1; p >= 1; p >>= 1) {
      int32_t l = loser[p];
      uint64_t lk = key[l];
      bool sw = lk < ck;
      loser[p] = sw ? cur : l;
      cur = sw ? l : cur;
      ck = sw ? lk : ck;
    }
    winner = cur;
  }
  delete[] loser;
  delete[] key;
  delete[] idx;
  return o + 1;
}

// Standalone homopolymer compression of a base-code buffer (codes, not
// chars): collapse runs of equal codes 0..3; 0xFF resets the run.
int64_t mt_hpc_codes(const uint8_t* in, int64_t n, uint8_t* out) {
  int64_t o = 0;
  uint8_t last = 0xFE;
  for (int64_t i = 0; i < n; i++) {
    uint8_t c = in[i];
    if (c == 0xFF) { out[o++] = c; last = 0xFE; continue; }
    if (c != last) { out[o++] = c; last = c; }
  }
  return o;
}

}  // extern "C"

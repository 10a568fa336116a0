// lako_native: host-side exact inner-product top-k (MIPS).
//
// CPU fallback for lako_tpu.retrieval.index.DenseIndex — the role faiss-cpu's
// IndexFlatIP plays in the reference (src/index.py:19-76) — for environments
// without an accelerator (data-prep boxes, CI). Multi-threaded, cache-blocked,
// with per-thread bounded heaps and a final merge.
//
// Build: make -C native  (produces liblako_native.so; loaded via ctypes from
// lako_tpu/retrieval/native.py)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Hit {
  float score;
  int64_t id;
  bool operator<(const Hit& o) const {
    // min-heap on score so the worst hit is on top
    return score > o.score;
  }
};

// Score one query against corpus rows [row_begin, row_end), maintaining a
// bounded min-heap of the best k.
void scan_block(const float* corpus, int64_t d, int64_t row_begin,
                int64_t row_end, const float* query, int64_t k,
                std::priority_queue<Hit>& heap) {
  for (int64_t r = row_begin; r < row_end; ++r) {
    const float* row = corpus + r * d;
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    int64_t j = 0;
    for (; j + 4 <= d; j += 4) {  // unrolled; compiler vectorizes with -O3
      acc0 += row[j] * query[j];
      acc1 += row[j + 1] * query[j + 1];
      acc2 += row[j + 2] * query[j + 2];
      acc3 += row[j + 3] * query[j + 3];
    }
    float acc = acc0 + acc1 + acc2 + acc3;
    for (; j < d; ++j) acc += row[j] * query[j];
    if ((int64_t)heap.size() < k) {
      heap.push({acc, r});
    } else if (acc > heap.top().score) {
      heap.pop();
      heap.push({acc, r});
    }
  }
}

}  // namespace

extern "C" {

// corpus: (n, d) row-major float32; queries: (q, d); outputs (q, k) each,
// sorted by descending score. Rows beyond n are never touched. Returns 0 on
// success.
int lako_mips_topk(const float* corpus, int64_t n, int64_t d,
                   const float* queries, int64_t q, int64_t k,
                   int64_t* out_ids, float* out_scores, int n_threads) {
  if (k <= 0 || k > n || n <= 0 || d <= 0 || q <= 0) return 1;
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());

  std::atomic<int64_t> next_query{0};
  auto worker = [&]() {
    for (;;) {
      int64_t qi = next_query.fetch_add(1);
      if (qi >= q) break;
      const float* query = queries + qi * d;
      std::priority_queue<Hit> heap;
      // corpus blocking keeps the query vector hot in L1 while streaming rows
      constexpr int64_t kBlock = 4096;
      for (int64_t b = 0; b < n; b += kBlock) {
        scan_block(corpus, d, b, std::min(n, b + kBlock), query, k, heap);
      }
      // drain heap (ascending) into the tail of the output row
      int64_t pos = k - 1;
      while (!heap.empty()) {
        out_ids[qi * k + pos] = heap.top().id;
        out_scores[qi * k + pos] = heap.top().score;
        heap.pop();
        --pos;
      }
      for (; pos >= 0; --pos) {  // k > hits found (cannot happen when k <= n)
        out_ids[qi * k + pos] = -1;
        out_scores[qi * k + pos] = -1e30f;
      }
    }
  };

  std::vector<std::thread> threads;
  int nt = std::min<int64_t>(n_threads, q);
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return 0;
}

// In-place re-rank: for each row of (q, c) candidate ids, compute scores
// against that row's query and sort descending.
int lako_mips_rerank(const float* corpus, int64_t n, int64_t d,
                     const float* queries, int64_t q, const int64_t* cand_ids,
                     int64_t c, int64_t* out_ids, float* out_scores,
                     int n_threads) {
  if (n <= 0 || d <= 0 || q <= 0 || c <= 0) return 1;
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  std::atomic<int64_t> next_query{0};
  auto worker = [&]() {
    std::vector<Hit> hits((size_t)c);
    for (;;) {
      int64_t qi = next_query.fetch_add(1);
      if (qi >= q) break;
      const float* query = queries + qi * d;
      for (int64_t j = 0; j < c; ++j) {
        int64_t id = cand_ids[qi * c + j];
        float acc = 0.f;
        if (id >= 0 && id < n) {
          const float* row = corpus + id * d;
          for (int64_t t = 0; t < d; ++t) acc += row[t] * query[t];
        } else {
          acc = -1e30f;
        }
        hits[j] = {acc, id};
      }
      std::sort(hits.begin(), hits.end(),
                [](const Hit& a, const Hit& b) { return a.score > b.score; });
      for (int64_t j = 0; j < c; ++j) {
        out_ids[qi * c + j] = hits[j].id;
        out_scores[qi * c + j] = hits[j].score;
      }
    }
  };
  std::vector<std::thread> threads;
  int nt = std::min<int64_t>(n_threads, q);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return 0;
}
}

// ---------------------------------------------------------------------------
// BM25-Okapi scoring over tokenized candidate documents (int token ids).
//
// The offline candidate-mining stage builds a BM25 index per question over its
// candidate facts (reference vqa2_deal.py:124-135); this is the CPU hot loop of
// preprocessing. Working on int ids (Python maps tokens <-> ids once per call)
// keeps the formulas bit-identical to lako_tpu/retrieval/bm25.py.
// ---------------------------------------------------------------------------

#include <cmath>
#include <unordered_map>

extern "C" {

// doc_tokens: concatenated token ids; doc_offsets: (n_docs+1) prefix offsets.
// query: qlen token ids. Writes the top-n doc indices (score-descending, ties
// by lower index like np.argsort(stable reversed)) into out_idx. Returns the
// number written (min(n, n_docs)) or -1 on bad input.
long long lako_bm25_topn(const long long* doc_tokens,
                         const long long* doc_offsets, long long n_docs,
                         const long long* query, long long qlen, double k1,
                         double b, double epsilon, long long* out_idx,
                         long long n) {
  if (n_docs <= 0 || qlen < 0 || n <= 0) return -1;

  std::vector<double> doc_len(n_docs);
  double total_len = 0.0;
  // term -> per-doc frequency postings
  std::unordered_map<long long, std::vector<std::pair<long long, double>>>
      postings;
  std::unordered_map<long long, long long> df;
  for (long long d = 0; d < n_docs; ++d) {
    long long beg = doc_offsets[d], end = doc_offsets[d + 1];
    doc_len[d] = (double)(end - beg);
    total_len += doc_len[d];
    std::unordered_map<long long, double> freq;
    for (long long t = beg; t < end; ++t) freq[doc_tokens[t]] += 1.0;
    for (auto& kv : freq) {
      postings[kv.first].push_back({d, kv.second});
      df[kv.first] += 1;
    }
  }
  double avgdl = total_len / (double)n_docs;

  // BM25Okapi idf with epsilon floor on negative values
  std::unordered_map<long long, double> idf;
  double idf_sum = 0.0;
  std::vector<long long> negative;
  for (auto& kv : df) {
    double v = std::log((double)n_docs - (double)kv.second + 0.5) -
               std::log((double)kv.second + 0.5);
    idf[kv.first] = v;
    idf_sum += v;
    if (v < 0) negative.push_back(kv.first);
  }
  double avg_idf = idf.empty() ? 0.0 : idf_sum / (double)idf.size();
  for (long long w : negative) idf[w] = epsilon * avg_idf;

  std::vector<double> score(n_docs, 0.0);
  for (long long qi = 0; qi < qlen; ++qi) {
    auto it = postings.find(query[qi]);
    if (it == postings.end()) continue;
    double w = idf[query[qi]];
    for (auto& p : it->second) {
      double f = p.second;
      score[p.first] +=
          w * f * (k1 + 1.0) /
          (f + k1 * (1.0 - b + b * doc_len[p.first] / avgdl));
    }
  }

  // top-n, score desc; ties resolved like np.argsort(score)[::-1]
  // (descending index among equal scores)
  std::vector<long long> order(n_docs);
  for (long long i = 0; i < n_docs; ++i) order[i] = i;
  long long keep = std::min(n, n_docs);
  std::partial_sort(order.begin(), order.begin() + keep, order.end(),
                    [&](long long a, long long bb) {
                      if (score[a] != score[bb]) return score[a] > score[bb];
                      return a > bb;
                    });
  for (long long i = 0; i < keep; ++i) out_idx[i] = order[i];
  return keep;
}
}

// Shim btllib/nthash.hpp for compiling the reference goldrush-path in this
// environment (real btllib is not vendored by the reference and cannot be
// downloaded here).  Implements exactly the hash semantics of
// goldrush_jax/ops/nthash_np.py (the executable hash spec both the JAX
// kernels and this harness are held to):
//
//   fwd(p) = XOR_{j in care} rol64(TAB[s[p+j]], span-1-j)
//   rev(p) = XOR_{j in care} rol64(TAB[3-s[p+j]], j)
//   hash   = min(fwd, rev)
//
// with the published ntHash per-base constants.  Only the SeedNtHash API
// surface used by multiLensfrHashIterator.hpp:28-67 is provided.
#ifndef SHIM_BTLLIB_NTHASH_HPP
#define SHIM_BTLLIB_NTHASH_HPP

#include <cstdint>
#include <string>
#include <vector>

namespace btllib {

inline uint64_t
shim_rol64(uint64_t x, unsigned r)
{
  r &= 63U;
  if (r == 0) {
    return x;
  }
  return (x << r) | (x >> (64U - r));
}

static const uint64_t SHIM_NT_TAB[4] = { 0x3C8BFBB395C60474ULL,
                                         0x3193C18562A02B4CULL,
                                         0x20323ED082572324ULL,
                                         0x295549F54BE24456ULL };

class SeedNtHash
{
public:
  SeedNtHash(const std::string& seq,
             const std::vector<std::string>& seeds,
             unsigned hash_num_per_seed,
             size_t k,
             size_t pos = 0)
    : m_seq(seq)
    , m_span(k)
    , m_pos(pos)
    , m_started(false)
    , m_hash(0)
  {
    (void)hash_num_per_seed;
    const std::string& seed = seeds[0];
    for (size_t j = 0; j < seed.size(); ++j) {
      if (seed[j] == '1') {
        m_care.push_back((unsigned)j);
      }
    }
    m_codes.resize(m_seq.size());
    for (size_t i = 0; i < m_seq.size(); ++i) {
      switch (m_seq[i]) {
        case 'A':
        case 'a':
          m_codes[i] = 0;
          break;
        case 'C':
        case 'c':
          m_codes[i] = 1;
          break;
        case 'G':
        case 'g':
          m_codes[i] = 2;
          break;
        case 'T':
        case 't':
          m_codes[i] = 3;
          break;
        default:
          // non-ACGT reads are excluded upstream (fill_bit_vector adds them
          // to filter_out_reads); any value works here
          m_codes[i] = 0;
          break;
      }
    }
  }

  bool roll()
  {
    size_t next = m_started ? m_pos + 1 : m_pos;
    if (next + m_span > m_codes.size()) {
      return false;
    }
    m_pos = next;
    m_started = true;
    uint64_t fwd = 0, rev = 0;
    for (unsigned j : m_care) {
      uint8_t b = m_codes[m_pos + j];
      fwd ^= shim_rol64(SHIM_NT_TAB[b], (unsigned)(m_span - 1 - j));
      rev ^= shim_rol64(SHIM_NT_TAB[3 - b], j);
    }
    m_hash = fwd < rev ? fwd : rev;
    return true;
  }

  const uint64_t* hashes() const { return &m_hash; }

private:
  std::string m_seq;
  std::vector<uint8_t> m_codes;
  std::vector<unsigned> m_care;
  size_t m_span;
  size_t m_pos;
  bool m_started;
  uint64_t m_hash;
};

} // namespace btllib

#endif

// Native data-loader core: TFRecord framing + tf.train.Example decoding.
//
// The port's own copy of the JAX package's host parser
// (vae_mdl_tpu/data/_native/io_native.cc). The pure-Python parser
// (vae_mdl_tpu_torch/data/tfrecord.py) is the fallback and the oracle; this
// core walks the record framing and the three Example fields (shape:int64s,
// data:bytes, label:int64) directly. It is a host-side parser: nothing here
// runs on the card.
//
// Build (done at first use by vae_mdl_tpu_torch.data.native, into
// vae_mdl_tpu_torch/_build/ under a hash of this file and the flags):
//   g++ -O2 -shared -fPIC -std=c++17 -o io_native.so io_native.cc
//
// ABI (ctypes): see vae_mdl_tpu_torch/data/native.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok() const { return p <= end; }
};

uint64_t read_varint(Cursor& c) {
  uint64_t result = 0;
  int shift = 0;
  while (c.p < c.end) {
    uint8_t b = *c.p++;
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) return result;
    shift += 7;
    if (shift > 63) break;
  }
  c.p = c.end + 1;  // poison
  return 0;
}

bool skip_field(Cursor& c, uint32_t wire) {
  switch (wire) {
    case 0: read_varint(c); return c.ok();
    case 1: c.p += 8; return c.ok();
    case 2: { uint64_t n = read_varint(c); c.p += n; return c.ok(); }
    case 5: c.p += 4; return c.ok();
    default: return false;
  }
}

struct Slice { const uint8_t* p = nullptr; uint64_t len = 0; };

// Walk a length-delimited submessage looking for a field number; returns the
// idx-th occurrence (idx=0 first).
bool find_field(Slice msg, uint32_t want_field, uint32_t want_wire, Slice* out,
                uint64_t* varint_out) {
  Cursor c{msg.p, msg.p + msg.len};
  while (c.p < c.end) {
    uint64_t tag = read_varint(c);
    if (!c.ok()) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    if (field == want_field && wire == want_wire) {
      if (wire == 2) {
        uint64_t n = read_varint(c);
        if (c.p + n > c.end) return false;
        out->p = c.p;
        out->len = n;
        return true;
      }
      if (wire == 0) {
        *varint_out = read_varint(c);
        return c.ok();
      }
    }
    if (!skip_field(c, wire)) return false;
  }
  return false;
}

// Features.feature map entries: iterate, match key name.
bool find_feature(Slice features, const char* name, Slice* feature_msg) {
  size_t name_len = strlen(name);
  Cursor c{features.p, features.p + features.len};
  while (c.p < c.end) {
    uint64_t tag = read_varint(c);
    if (!c.ok()) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    if (field == 1 && wire == 2) {  // map entry
      uint64_t n = read_varint(c);
      if (c.p + n > c.end) return false;
      Slice entry{c.p, n};
      c.p += n;
      Slice key, value;
      uint64_t dummy;
      if (find_field(entry, 1, 2, &key, &dummy) &&
          key.len == name_len && memcmp(key.p, name, name_len) == 0 &&
          find_field(entry, 2, 2, &value, &dummy)) {
        *feature_msg = value;
        return true;
      }
      continue;
    }
    if (!skip_field(c, wire)) return false;
  }
  return false;
}

// Feature{bytes_list=1 / float_list=2 / int64_list=3}
bool feature_bytes(Slice feature, Slice* out) {
  Slice lst;
  uint64_t dummy;
  if (!find_field(feature, 1, 2, &lst, &dummy)) return false;  // BytesList
  return find_field(lst, 1, 2, out, &dummy);  // first value
}

int feature_int64s(Slice feature, int64_t* out, int max_out) {
  Slice lst;
  uint64_t dummy;
  if (!find_field(feature, 3, 2, &lst, &dummy)) return -1;  // Int64List
  int n = 0;
  Cursor c{lst.p, lst.p + lst.len};
  while (c.p < c.end && n < max_out) {
    uint64_t tag = read_varint(c);
    if (!c.ok()) return -1;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    if (field == 1 && wire == 0) {
      out[n++] = static_cast<int64_t>(read_varint(c));
      if (!c.ok()) return -1;
      continue;
    }
    if (field == 1 && wire == 2) {  // packed
      uint64_t len = read_varint(c);
      Cursor pc{c.p, c.p + len};
      c.p += len;
      while (pc.p < pc.end && n < max_out)
        out[n++] = static_cast<int64_t>(read_varint(pc));
      continue;
    }
    if (!skip_field(c, wire)) return -1;
  }
  return n;
}

}  // namespace

extern "C" {

// Parse one TFRecord file of Glow-CelebA Examples.
//   out_imgs   : caller buffer, max_records * img_bytes uint8
//   out_shapes : caller buffer, max_records * 3 int64 (H, W, C per record)
//   out_labels : caller buffer, max_records int64
// Returns number of records parsed, or -errno-style negative on error.
long parse_celeba_tfrecord(const char* path, uint8_t* out_imgs,
                           int64_t* out_shapes, int64_t* out_labels,
                           long max_records, long img_bytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<uint8_t> buf;
  long count = 0;
  while (count < max_records) {
    uint8_t header[12];
    if (fread(header, 1, 12, f) != 12) break;
    uint64_t length;
    memcpy(&length, header, 8);  // little-endian framing
    buf.resize(length);
    if (fread(buf.data(), 1, length, f) != length) break;
    uint8_t crc[4];
    if (fread(crc, 1, 4, f) != 4) break;

    // Example{features=1}
    Slice example{buf.data(), length};
    Slice features, feat;
    uint64_t dummy;
    if (!find_field(example, 1, 2, &features, &dummy)) { fclose(f); return -2; }

    int64_t shape[3] = {0, 0, 0};
    if (!find_feature(features, "shape", &feat) ||
        feature_int64s(feat, shape, 3) != 3) { fclose(f); return -3; }

    Slice data;
    if (!find_feature(features, "data", &feat) ||
        !feature_bytes(feat, &data)) { fclose(f); return -4; }
    int64_t need = shape[0] * shape[1] * shape[2];
    if (static_cast<int64_t>(data.len) < need || need > img_bytes) {
      fclose(f);
      return -5;
    }

    int64_t label = 0;
    if (find_feature(features, "label", &feat)) {
      int64_t tmp[1] = {0};
      if (feature_int64s(feat, tmp, 1) >= 1) label = tmp[0];
    }

    memcpy(out_imgs + count * img_bytes, data.p, need);
    memcpy(out_shapes + count * 3, shape, sizeof(shape));
    out_labels[count] = label;
    ++count;
  }
  fclose(f);
  return count;
}

// Count records in a TFRecord file (framing walk only).
long count_tfrecords(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long count = 0;
  uint8_t header[12];
  while (fread(header, 1, 12, f) == 12) {
    uint64_t length;
    memcpy(&length, header, 8);
    if (fseek(f, static_cast<long>(length) + 4, SEEK_CUR) != 0) break;
    ++count;
  }
  fclose(f);
  return count;
}

}  // extern "C"

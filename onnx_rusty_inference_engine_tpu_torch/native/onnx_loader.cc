// Native ONNX ModelProto wire-format parser.
//
// The TPU-native counterpart of the reference's native deserialization layer
// (reference: Rust `onnx-protobuf` crate usage at src/main.rs:30). The
// Python engine calls this through ctypes (native_loader.py) for fast model
// loading — varint scanning and tensor decoding happen here; graph lowering
// stays in Python/JAX. Pure C++17, no protobuf dependency: the wire format
// is decoded directly (same schema semantics as the vendored ONNX .proto).
//
// Build: make -C onnx_rusty_inference_engine_tpu/native

#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Slice {
  const uint8_t* ptr = nullptr;
  size_t len = 0;
};

struct Attr {
  std::string name;
  Slice raw;  // full AttributeProto bytes (decoded Python-side; attrs are tiny)
};

struct Node {
  std::string op_type, name, domain;
  std::vector<std::string> inputs, outputs;
  std::vector<Attr> attrs;
};

struct Tensor {
  std::string name;
  int32_t data_type = 1;
  std::vector<int64_t> dims;
  // Either raw little-endian bytes (raw_data) or typed repeated fields
  // normalized into `data` as raw LE bytes of the target dtype.
  std::vector<uint8_t> data;
};

struct ValueInfo {
  std::string name;
  int32_t elem_type = 0;
  std::vector<int64_t> dims;       // -1 encodes a symbolic dim
  std::vector<std::string> dim_params;
};

struct Model {
  int64_t ir_version = 0, opset_version = 0, model_version = 0;
  // ALL opset_import entries (domain, version) — opset_import is
  // `repeated`; opset_version above tracks only the ai.onnx ("" domain)
  // entry so contrib imports can never flip default-domain semantics.
  std::vector<std::pair<std::string, int64_t>> opset_imports;
  std::string producer_name, producer_version, domain, graph_name;
  std::vector<Node> nodes;
  std::vector<Tensor> initializers;
  std::vector<ValueInfo> inputs, outputs, value_infos;
  std::string error;
  bool has_graph = false;
};

class Reader {
 public:
  Reader(const uint8_t* buf, size_t len) : p_(buf), end_(buf + len) {}

  bool done() const { return p_ >= end_; }
  // clean parse = every next() advanced without hitting a malformed or
  // truncated field (a varint truncated AT the buffer end leaves p_ == end_,
  // so done() alone cannot distinguish truncation from a clean finish)
  bool ok() const { return !corrupt_; }

  bool read_varint(uint64_t* out) {
    uint64_t result = 0;
    int shift = 0;
    while (p_ < end_) {
      uint8_t b = *p_++;
      result |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) {
        *out = result;
        return true;
      }
      shift += 7;
      if (shift > 70) { corrupt_ = true; return false; }
    }
    corrupt_ = true;  // continuation bit set on the last byte
    return false;
  }

  // Returns false at clean end or on corruption (see ok()).
  bool next(uint32_t* field, uint32_t* wire, uint64_t* varint, Slice* bytes) {
    if (done()) return false;
    uint64_t key;
    if (!read_varint(&key)) return false;
    *field = static_cast<uint32_t>(key >> 3);
    *wire = static_cast<uint32_t>(key & 7);
    switch (*wire) {
      case 0:
        return read_varint(varint);
      case 2: {
        uint64_t len;
        if (!read_varint(&len)) return false;
        if (p_ + len > end_ || p_ + len < p_) { corrupt_ = true; return false; }
        bytes->ptr = p_;
        bytes->len = static_cast<size_t>(len);
        p_ += len;
        return true;
      }
      case 5:
        if (p_ + 4 > end_) { corrupt_ = true; return false; }
        bytes->ptr = p_;
        bytes->len = 4;
        p_ += 4;
        return true;
      case 1:
        if (p_ + 8 > end_) { corrupt_ = true; return false; }
        bytes->ptr = p_;
        bytes->len = 8;
        p_ += 8;
        return true;
      case 3:
      case 4:
        return true;  // obsolete group markers: skip (matches Python codec)
      default:
        corrupt_ = true;
        return false;
    }
  }

 private:
  const uint8_t* p_;
  const uint8_t* end_;
  bool corrupt_ = false;
};

std::string to_string(const Slice& s) {
  return std::string(reinterpret_cast<const char*>(s.ptr), s.len);
}

int64_t zz_to_i64(uint64_t v) { return static_cast<int64_t>(v); }

void parse_packed_varints(const Slice& s, std::vector<int64_t>* out) {
  Reader r(s.ptr, s.len);
  uint64_t v;
  while (!r.done() && r.read_varint(&v)) out->push_back(zz_to_i64(v));
}

bool parse_tensor(const Slice& s, Tensor* t) {
  Reader r(s.ptr, s.len);
  uint32_t field, wire;
  uint64_t vi;
  Slice bytes;
  std::vector<uint8_t> typed;  // from float_data / int64_data etc.
  while (r.next(&field, &wire, &vi, &bytes)) {
    switch (field) {
      case 1:
        if (wire == 0) t->dims.push_back(zz_to_i64(vi));
        else parse_packed_varints(bytes, &t->dims);
        break;
      case 2:
        t->data_type = static_cast<int32_t>(vi);
        break;
      case 4:  // float_data (packed f32) — already LE bytes
      case 10: // double_data
        typed.insert(typed.end(), bytes.ptr, bytes.ptr + bytes.len);
        break;
      case 5:
      case 7: {  // int32_data / int64_data: varints -> LE int64 bytes is wrong
                 // for int32 targets; normalize to int64 and let Python cast.
        std::vector<int64_t> vals;
        if (wire == 0) vals.push_back(zz_to_i64(vi));
        else parse_packed_varints(bytes, &vals);
        size_t off = typed.size();
        typed.resize(off + vals.size() * 8);
        std::memcpy(typed.data() + off, vals.data(), vals.size() * 8);
        if (field == 5 || field == 7) t->data_type = t->data_type;  // keep
        break;
      }
      case 8:
        t->name = to_string(bytes);
        break;
      case 9:
        t->data.assign(bytes.ptr, bytes.ptr + bytes.len);
        break;
      case 13:
        // external_data: a CAPABILITY gap, not corruption. Sentinel dtype
        // makes the Python bridge fall back to the pure-Python parser
        // (which resolves sidecar files) instead of erroring.
        t->data_type = -1;
        return true;
      default:
        break;
    }
  }
  if (t->data.empty() && !typed.empty()) {
    t->data = std::move(typed);
    // Python reads typed int fields as int64 then casts to the declared dtype.
  }
  // reader stopping mid-buffer = truncated/corrupt message
  return r.done() && r.ok();
}

bool parse_node(const Slice& s, Node* n) {
  Reader r(s.ptr, s.len);
  uint32_t field, wire;
  uint64_t vi;
  Slice bytes;
  while (r.next(&field, &wire, &vi, &bytes)) {
    switch (field) {
      case 1: n->inputs.push_back(to_string(bytes)); break;
      case 2: n->outputs.push_back(to_string(bytes)); break;
      case 3: n->name = to_string(bytes); break;
      case 4: n->op_type = to_string(bytes); break;
      case 5: {
        // extract attribute name; keep raw bytes for Python-side decode
        Attr a;
        a.raw = bytes;
        Reader ar(bytes.ptr, bytes.len);
        uint32_t f2, w2;
        uint64_t v2;
        Slice b2;
        while (ar.next(&f2, &w2, &v2, &b2)) {
          if (f2 == 1) { a.name = to_string(b2); break; }
        }
        n->attrs.push_back(std::move(a));
        break;
      }
      case 7: n->domain = to_string(bytes); break;
      default: break;
    }
  }
  return r.done() && r.ok();
}

bool parse_value_info(const Slice& s, ValueInfo* v) {
  Reader r(s.ptr, s.len);
  uint32_t field, wire;
  uint64_t vi;
  Slice bytes;
  while (r.next(&field, &wire, &vi, &bytes)) {
    if (field == 1) {
      v->name = to_string(bytes);
    } else if (field == 2) {  // TypeProto
      Reader tr(bytes.ptr, bytes.len);
      uint32_t f2, w2; uint64_t v2; Slice b2;
      while (tr.next(&f2, &w2, &v2, &b2)) {
        if (f2 != 1) continue;  // tensor_type
        Reader tt(b2.ptr, b2.len);
        uint32_t f3, w3; uint64_t v3; Slice b3;
        while (tt.next(&f3, &w3, &v3, &b3)) {
          if (f3 == 1) v->elem_type = static_cast<int32_t>(v3);
          else if (f3 == 2) {  // TensorShapeProto
            Reader sh(b3.ptr, b3.len);
            uint32_t f4, w4; uint64_t v4; Slice b4;
            while (sh.next(&f4, &w4, &v4, &b4)) {
              if (f4 != 1) continue;  // Dimension
              Reader dr(b4.ptr, b4.len);
              uint32_t f5, w5; uint64_t v5; Slice b5;
              int64_t dim = -1;
              std::string param;
              while (dr.next(&f5, &w5, &v5, &b5)) {
                if (f5 == 1) dim = zz_to_i64(v5);
                else if (f5 == 2) param = to_string(b5);
              }
              v->dims.push_back(dim);
              v->dim_params.push_back(param);
            }
          }
        }
      }
    }
  }
  return r.done() && r.ok();
}

bool parse_graph(const Slice& s, Model* m) {
  Reader r(s.ptr, s.len);
  uint32_t field, wire;
  uint64_t vi;
  Slice bytes;
  while (r.next(&field, &wire, &vi, &bytes)) {
    switch (field) {
      case 1: {
        Node n;
        if (!parse_node(bytes, &n)) return false;
        m->nodes.push_back(std::move(n));
        break;
      }
      case 2: m->graph_name = to_string(bytes); break;
      case 5: {
        Tensor t;
        if (!parse_tensor(bytes, &t)) return false;
        m->initializers.push_back(std::move(t));
        break;
      }
      case 11: {
        ValueInfo v;
        if (!parse_value_info(bytes, &v)) return false;
        m->inputs.push_back(std::move(v));
        break;
      }
      case 12: {
        ValueInfo v;
        if (!parse_value_info(bytes, &v)) return false;
        m->outputs.push_back(std::move(v));
        break;
      }
      case 13: {
        ValueInfo v;
        if (!parse_value_info(bytes, &v)) return false;
        m->value_infos.push_back(std::move(v));
        break;
      }
      default: break;
    }
  }
  return r.done() && r.ok();
}

}  // namespace

extern "C" {

void* oriet_parse_model(const uint8_t* buf, size_t len) {
  auto m = std::make_unique<Model>();
  Reader r(buf, len);
  uint32_t field, wire;
  uint64_t vi;
  Slice bytes;
  while (r.next(&field, &wire, &vi, &bytes)) {
    switch (field) {
      case 1: m->ir_version = zz_to_i64(vi); break;
      case 2: m->producer_name = to_string(bytes); break;
      case 3: m->producer_version = to_string(bytes); break;
      case 4: m->domain = to_string(bytes); break;
      case 5: m->model_version = zz_to_i64(vi); break;
      case 7:
        if (!parse_graph(bytes, m.get())) {
          m->error = "graph parse failed (truncated or corrupt)";
          break;
        }
        m->has_graph = true;
        break;
      case 8: {  // opset_import (repeated OperatorSetIdProto)
        Reader orr(bytes.ptr, bytes.len);
        uint32_t f2, w2; uint64_t v2; Slice b2;
        std::string dom;
        int64_t ver = -1;
        while (orr.next(&f2, &w2, &v2, &b2)) {
          if (f2 == 1) dom = to_string(b2);
          else if (f2 == 2) ver = zz_to_i64(v2);
        }
        if (ver >= 0) {
          m->opset_imports.emplace_back(dom, ver);
          if (dom.empty() || dom == "ai.onnx") m->opset_version = ver;
        }
        break;
      }
      default: break;
    }
  }
  if (m->error.empty() && !(r.done() && r.ok()))
    m->error = "truncated or corrupt protobuf stream";
  if (m->error.empty() && !m->has_graph)
    m->error = "ModelProto has no graph";
  return m.release();
}

void oriet_free_model(void* h) { delete static_cast<Model*>(h); }

const char* oriet_error(void* h) {
  auto* m = static_cast<Model*>(h);
  return m->error.empty() ? nullptr : m->error.c_str();
}

int64_t oriet_ir_version(void* h) { return static_cast<Model*>(h)->ir_version; }
int64_t oriet_opset(void* h) { return static_cast<Model*>(h)->opset_version; }
size_t oriet_num_opset_imports(void* h) { return static_cast<Model*>(h)->opset_imports.size(); }
const char* oriet_opset_import_domain(void* h, size_t i) { return static_cast<Model*>(h)->opset_imports[i].first.c_str(); }
int64_t oriet_opset_import_version(void* h, size_t i) { return static_cast<Model*>(h)->opset_imports[i].second; }
int64_t oriet_model_version(void* h) { return static_cast<Model*>(h)->model_version; }
const char* oriet_producer(void* h) { return static_cast<Model*>(h)->producer_name.c_str(); }
const char* oriet_producer_version(void* h) { return static_cast<Model*>(h)->producer_version.c_str(); }
const char* oriet_domain(void* h) { return static_cast<Model*>(h)->domain.c_str(); }
const char* oriet_graph_name(void* h) { return static_cast<Model*>(h)->graph_name.c_str(); }

// --- nodes ---------------------------------------------------------------
size_t oriet_num_nodes(void* h) { return static_cast<Model*>(h)->nodes.size(); }
const char* oriet_node_op(void* h, size_t i) { return static_cast<Model*>(h)->nodes[i].op_type.c_str(); }
const char* oriet_node_name(void* h, size_t i) { return static_cast<Model*>(h)->nodes[i].name.c_str(); }
const char* oriet_node_domain(void* h, size_t i) { return static_cast<Model*>(h)->nodes[i].domain.c_str(); }
size_t oriet_node_num_inputs(void* h, size_t i) { return static_cast<Model*>(h)->nodes[i].inputs.size(); }
const char* oriet_node_input(void* h, size_t i, size_t j) { return static_cast<Model*>(h)->nodes[i].inputs[j].c_str(); }
size_t oriet_node_num_outputs(void* h, size_t i) { return static_cast<Model*>(h)->nodes[i].outputs.size(); }
const char* oriet_node_output(void* h, size_t i, size_t j) { return static_cast<Model*>(h)->nodes[i].outputs[j].c_str(); }
size_t oriet_node_num_attrs(void* h, size_t i) { return static_cast<Model*>(h)->nodes[i].attrs.size(); }
const char* oriet_node_attr_name(void* h, size_t i, size_t j) { return static_cast<Model*>(h)->nodes[i].attrs[j].name.c_str(); }
const uint8_t* oriet_node_attr_raw(void* h, size_t i, size_t j, size_t* len) {
  auto& a = static_cast<Model*>(h)->nodes[i].attrs[j];
  *len = a.raw.len;
  return a.raw.ptr;  // valid only while the caller keeps the model buffer alive
}

// --- initializers ----------------------------------------------------------
size_t oriet_num_initializers(void* h) { return static_cast<Model*>(h)->initializers.size(); }
const char* oriet_init_name(void* h, size_t i) { return static_cast<Model*>(h)->initializers[i].name.c_str(); }
int32_t oriet_init_dtype(void* h, size_t i) { return static_cast<Model*>(h)->initializers[i].data_type; }
size_t oriet_init_ndim(void* h, size_t i) { return static_cast<Model*>(h)->initializers[i].dims.size(); }
const int64_t* oriet_init_dims(void* h, size_t i) { return static_cast<Model*>(h)->initializers[i].dims.data(); }
const uint8_t* oriet_init_data(void* h, size_t i, size_t* len) {
  auto& t = static_cast<Model*>(h)->initializers[i];
  *len = t.data.size();
  return t.data.data();
}

// --- value infos ------------------------------------------------------------
static std::vector<ValueInfo>& vi_list(void* h, int kind) {
  auto* m = static_cast<Model*>(h);
  return kind == 0 ? m->inputs : (kind == 1 ? m->outputs : m->value_infos);
}
size_t oriet_num_vi(void* h, int kind) { return vi_list(h, kind).size(); }
const char* oriet_vi_name(void* h, int kind, size_t i) { return vi_list(h, kind)[i].name.c_str(); }
int32_t oriet_vi_elem_type(void* h, int kind, size_t i) { return vi_list(h, kind)[i].elem_type; }
size_t oriet_vi_ndim(void* h, int kind, size_t i) { return vi_list(h, kind)[i].dims.size(); }
const int64_t* oriet_vi_dims(void* h, int kind, size_t i) { return vi_list(h, kind)[i].dims.data(); }
const char* oriet_vi_dim_param(void* h, int kind, size_t i, size_t j) {
  auto& s = vi_list(h, kind)[i].dim_params[j];
  return s.c_str();
}

}  // extern "C"

// --- standalone TensorProto decode (golden .pb data loader) -----------------
extern "C" {

void* oriet_parse_tensor(const uint8_t* buf, size_t len) {
  auto t = std::make_unique<Tensor>();
  Slice s{buf, len};
  if (!parse_tensor(s, t.get())) return nullptr;
  return t.release();
}

void oriet_free_tensor(void* h) { delete static_cast<Tensor*>(h); }
const char* oriet_tensor_name(void* h) { return static_cast<Tensor*>(h)->name.c_str(); }
int32_t oriet_tensor_dtype(void* h) { return static_cast<Tensor*>(h)->data_type; }
size_t oriet_tensor_ndim(void* h) { return static_cast<Tensor*>(h)->dims.size(); }
const int64_t* oriet_tensor_dims(void* h) { return static_cast<Tensor*>(h)->dims.data(); }
const uint8_t* oriet_tensor_data(void* h, size_t* len) {
  auto* t = static_cast<Tensor*>(h);
  *len = t->data.size();
  return t->data.data();
}

}  // extern "C"

// Fast columnar g2o-dialect reader.
//
// Native host-path component: the reference's parser is C++
// (reference include/slam/Parser.h:1138 CParserTemplate + per-token parse
// primitives in include/slam_app/ParsePrimitives.h); this is this build's
// equivalent.  Reads the full token registry in one pass and buckets records
// into per-token columnar arrays (int ids + double payloads) that the Python
// binding turns into GraphSystem stores wholesale — the per-line float
// parsing and dispatch run at C++ speed, the graph semantics stay in one
// place (io/parser.py applies identical conventions).
//
// C API (ctypes-friendly), no external dependencies.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// token kinds — keep in sync with io/native_parser.py
enum TokenKind : int32_t {
    TK_UNKNOWN = 0,
    TK_VERTEX2,          // id, [x y th]
    TK_EDGE2,            // id0 id1, [z3, ut6]
    TK_LANDMARK2_XY,     // id0 id1, [x y (info...)]
    TK_LANDMARK2_RB,     // id0 id1, [r b ut3]
    TK_VERTEX3,          // id, [x y z roll pitch yaw]
    TK_EDGE3,            // id0 id1, [t3 rpy3 ut21]
    TK_EDGE3_AXISANGLE,  // id0 id1, [t3 aa3 ut21]
    TK_VERTEX_XYZ,       // id, [x y z]
    TK_LANDMARK3_XYZ,    // id0 id1, [z3 ut6]
    TK_VERTEX_CAM,       // id, [pos3 quat4 fx fy cx cy d]
    TK_VERTEX_INTRINSICS,// id, [fx fy cx cy d]
    TK_VERTEX_SCAM,      // id, [pos3 quat4 fx fy cx cy d b]
    TK_VERTEX_SPHERON,   // id, [pos3 quat4]
    TK_EDGE_P2C,         // id0 id1, [u v ut3]
    TK_EDGE_P2CI,        // id0 id1 id2, [u v ut3]
    TK_EDGE_P2SC,        // id0 id1, [ul vl ur ut6]
    TK_EDGE_SPHERON_XYZ, // id0 id1, [z3 ut6]
    TK_ROCV_TRANSMITTER, // id, [6 values]
    TK_ROCV_TRANSMITTER_UF, // id, [ut6]
    TK_ROCV_RECEIVER,    // id, [6 values]
    TK_ROCV_DELTA_TIME,  // id0 id1, [dt ut21]
    TK_ROCV_RANGE,       // id0 id1, [range cov]
    TK_CONSISTENCY_MARKER,
    TK_EQUIV,
    TK_COUNT
};

struct Record {
    int32_t kind;
    int32_t ids[3];
    int32_t n_vals;
    int32_t val_off;   // offset into the value pool
};

struct ParseResult {
    std::vector<Record> records;
    std::vector<double> values;
    int64_t n_lines = 0;
    int64_t n_unknown = 0;
    int64_t n_truncated = 0;
};

struct TokenSpec {
    TokenKind kind;
    int n_ids;
    int n_vals;   // expected doubles after the ids (minimum)
};

const std::unordered_map<std::string, TokenSpec>& token_map() {
    static const std::unordered_map<std::string, TokenSpec> m = {
        {"VERTEX2", {TK_VERTEX2, 1, 3}},
        {"VERTEX_SE2", {TK_VERTEX2, 1, 3}},
        {"VERTEX", {TK_VERTEX2, 1, 3}},
        {"EDGE2", {TK_EDGE2, 2, 9}},
        {"EDGE_SE2", {TK_EDGE2, 2, 9}},
        {"EDGE", {TK_EDGE2, 2, 9}},
        {"ODOMETRY", {TK_EDGE2, 2, 9}},
        {"LANDMARK2:XY", {TK_LANDMARK2_XY, 2, 2}},
        {"EDGE_SE2_XY", {TK_LANDMARK2_XY, 2, 2}},
        {"EDGE_BEARING_SE2_XY", {TK_LANDMARK2_XY, 2, 2}},
        {"LANDMARK", {TK_LANDMARK2_XY, 2, 2}},
        {"LANDMARK2:RB", {TK_LANDMARK2_RB, 2, 5}},
        {"EDGE_SE2_RB", {TK_LANDMARK2_RB, 2, 5}},
        {"EDGE_BEARING_SE2_RB", {TK_LANDMARK2_RB, 2, 5}},
        {"VERTEX3", {TK_VERTEX3, 1, 6}},
        {"VERTEX_SE3", {TK_VERTEX3, 1, 6}},
        {"EDGE3", {TK_EDGE3, 2, 27}},
        {"EDGE_SE3", {TK_EDGE3, 2, 27}},
        {"EDGE3:AXISANGLE", {TK_EDGE3_AXISANGLE, 2, 27}},
        {"EDGE_SE3:AXISANGLE", {TK_EDGE3_AXISANGLE, 2, 27}},
        {"VERTEX_XYZ", {TK_VERTEX_XYZ, 1, 3}},
        {"LANDMARK3:XYZ", {TK_LANDMARK3_XYZ, 2, 9}},
        {"EDGE_SE3_XYZ", {TK_LANDMARK3_XYZ, 2, 9}},
        {"VERTEX_CAM", {TK_VERTEX_CAM, 1, 12}},
        {"VERTEX_INTRINSICS", {TK_VERTEX_INTRINSICS, 1, 5}},
        {"VERTEX_SCAM", {TK_VERTEX_SCAM, 1, 13}},
        {"VERTEX_SPHERON:QUAT", {TK_VERTEX_SPHERON, 1, 7}},
        {"EDGE_PROJECT_P2MC", {TK_EDGE_P2C, 2, 5}},
        {"EDGE_P2MC", {TK_EDGE_P2C, 2, 5}},
        {"EDGE_P2C", {TK_EDGE_P2C, 2, 5}},
        {"EDGE_PROJECT_P2MCI", {TK_EDGE_P2CI, 3, 5}},
        {"EDGE_P2MCI", {TK_EDGE_P2CI, 3, 5}},
        {"EDGE_P2CI", {TK_EDGE_P2CI, 3, 5}},
        {"EDGE_PROJECT_P2SC", {TK_EDGE_P2SC, 2, 9}},
        {"EDGE_P2SC", {TK_EDGE_P2SC, 2, 9}},
        {"EDGE_SPHERON_XYZ", {TK_EDGE_SPHERON_XYZ, 2, 9}},
        {"ROCV:TRANSMITTER", {TK_ROCV_TRANSMITTER, 1, 3}},
        {"ROCV:TRANSMITTER_UF", {TK_ROCV_TRANSMITTER_UF, 1, 6}},
        {"ROCV:RECEIVER", {TK_ROCV_RECEIVER, 1, 6}},
        {"ROCV:RECEIVER_GTFAKE", {TK_ROCV_RECEIVER, 1, 6}},
        {"ROCV:DELTA_TIME", {TK_ROCV_DELTA_TIME, 2, 22}},
        {"ROCV:RANGE", {TK_ROCV_RANGE, 2, 2}},
        {"CONSISTENCY_MARKER", {TK_CONSISTENCY_MARKER, 0, 0}},
        {"EQUIV", {TK_EQUIV, 2, 0}},
        {"PHASE", {TK_EQUIV, 0, 0}},
    };
    return m;
}

}  // namespace

extern "C" {

ParseResult* spp_parse(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;

    auto* res = new ParseResult();
    res->records.reserve(1 << 16);
    res->values.reserve(1 << 20);

    const auto& toks = token_map();
    std::string line;
    char buf[1 << 16];
    while (fgets(buf, sizeof(buf), f)) {
        ++res->n_lines;
        char* p = buf;
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '\0' || *p == '\n' || *p == '\r' ||
            *p == '#' || *p == '%' || (p[0] == '/' && p[1] == '/'))
            continue;

        // token (uppercased)
        char* tok_start = p;
        while (*p && !isspace((unsigned char)*p)) {
            *p = (char)toupper((unsigned char)*p);
            ++p;
        }
        std::string tok(tok_start, p - tok_start);
        auto it = toks.find(tok);
        if (it == toks.end()) {
            ++res->n_unknown;
            continue;
        }
        const TokenSpec& spec = it->second;

        Record rec;
        rec.kind = spec.kind;
        rec.ids[0] = rec.ids[1] = rec.ids[2] = -1;
        bool ok = true;
        for (int k = 0; k < spec.n_ids; ++k) {
            char* end;
            long v = strtol(p, &end, 10);
            if (end == p) { ok = false; break; }
            rec.ids[k] = (int32_t)v;
            p = end;
        }
        rec.val_off = (int32_t)res->values.size();
        int n_vals = 0;
        if (ok) {
            while (true) {
                char* end;
                double v = strtod(p, &end);
                if (end == p) break;
                res->values.push_back(v);
                ++n_vals;
                p = end;
            }
            if (n_vals < spec.n_vals) ok = false;
        }
        rec.n_vals = n_vals;
        if (!ok) {
            ++res->n_truncated;
            res->values.resize(rec.val_off);
            fprintf(stderr, "error: line %lld: line is truncated\n",
                    (long long)res->n_lines);
            continue;
        }
        res->records.push_back(rec);
    }
    fclose(f);
    return res;
}

int64_t spp_num_records(const ParseResult* r) {
    return (int64_t)r->records.size();
}

int64_t spp_num_values(const ParseResult* r) {
    return (int64_t)r->values.size();
}

// copies out the record table as 6 int32 columns: kind, id0, id1, id2,
// n_vals, val_off  (row-major [n, 6])
void spp_copy_records(const ParseResult* r, int32_t* out) {
    for (size_t i = 0; i < r->records.size(); ++i) {
        const Record& rec = r->records[i];
        out[i * 6 + 0] = rec.kind;
        out[i * 6 + 1] = rec.ids[0];
        out[i * 6 + 2] = rec.ids[1];
        out[i * 6 + 3] = rec.ids[2];
        out[i * 6 + 4] = rec.n_vals;
        out[i * 6 + 5] = rec.val_off;
    }
}

void spp_copy_values(const ParseResult* r, double* out) {
    memcpy(out, r->values.data(), r->values.size() * sizeof(double));
}

int64_t spp_stat(const ParseResult* r, int which) {
    switch (which) {
        case 0: return r->n_lines;
        case 1: return r->n_unknown;
        case 2: return r->n_truncated;
    }
    return -1;
}

void spp_free(ParseResult* r) { delete r; }

}  // extern "C"

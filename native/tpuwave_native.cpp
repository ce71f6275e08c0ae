// tpuwave native runtime: fast host-side IO + mesh connectivity.
//
// The reference offloads its runtime (mesh build, VTU output) to native
// deal.II/Trilinos code; this library is the tpuwave equivalent for the
// host-side parts that stay off the accelerator: raw-appended binary VTU writing
// (DataOut::write_vtu_with_pvtu_record parity), legacy VTK mesh snapshots
// (GridOut::write_vtk parity), and O(N) structured-mesh connectivity
// builders. Exposed as a C ABI for ctypes; Python falls back to numpy
// implementations when the shared library is unavailable.
//
// Build: make -C native   (produces libwave_native.so)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Connectivity builders (structured triangulated rectangle, lower/upper
// diagonal split; see tpuwave/core/mesh.py for the layout contract)
// ---------------------------------------------------------------------------

// out: (2*nx*ny, 3) int32 triangle -> vertex indices
void tw_p1_cells(int32_t nx, int32_t ny, int32_t* out) {
    int64_t k = 0;
    for (int32_t j = 0; j < ny; ++j) {
        for (int32_t i = 0; i < nx; ++i) {
            const int32_t v00 = j * (nx + 1) + i;
            const int32_t v10 = v00 + 1;
            const int32_t v01 = v00 + (nx + 1);
            const int32_t v11 = v01 + 1;
            out[k++] = v00; out[k++] = v10; out[k++] = v11;  // lower
            out[k++] = v00; out[k++] = v11; out[k++] = v01;  // upper
        }
    }
}

// out: (2*nx*ny, 6) int32 cell -> global P2 DoFs
// edge numbering: horizontal block, then vertical, then diagonal
void tw_p2_cell_dofs(int32_t nx, int32_t ny, int32_t* out) {
    const int32_t nv = (nx + 1) * (ny + 1);
    const int32_t h0 = nv;                       // horizontal edges
    const int32_t v0 = h0 + nx * (ny + 1);       // vertical edges
    const int32_t d0 = v0 + (nx + 1) * ny;       // diagonal edges
    int64_t k = 0;
    for (int32_t j = 0; j < ny; ++j) {
        for (int32_t i = 0; i < nx; ++i) {
            const int32_t c00 = j * (nx + 1) + i;
            const int32_t c10 = c00 + 1;
            const int32_t c01 = c00 + (nx + 1);
            const int32_t c11 = c01 + 1;
            const int32_t h_b = h0 + j * nx + i;        // bottom h-edge
            const int32_t h_t = h0 + (j + 1) * nx + i;  // top h-edge
            const int32_t v_l = v0 + j * (nx + 1) + i;  // left v-edge
            const int32_t v_r = v_l + 1;                // right v-edge
            const int32_t dia = d0 + j * nx + i;        // diagonal
            // lower (v00, v10, v11): e01=h_b, e12=v_r, e20=dia
            out[k++] = c00; out[k++] = c10; out[k++] = c11;
            out[k++] = h_b; out[k++] = v_r; out[k++] = dia;
            // upper (v00, v11, v01): e01=dia, e12=h_t, e20=v_l
            out[k++] = c00; out[k++] = c11; out[k++] = c01;
            out[k++] = dia; out[k++] = h_t; out[k++] = v_l;
        }
    }
}

// ---------------------------------------------------------------------------
// VTU writer (XML header + raw appended binary payload)
// ---------------------------------------------------------------------------

namespace {

struct Block {
    const char* bytes;
    uint64_t size;
};

void append_block(std::string& xml, std::vector<Block>& blocks,
                  uint64_t& offset, const char* dtype, const char* name,
                  int ncomp, const void* data, uint64_t nbytes) {
    char buf[512];
    std::snprintf(buf, sizeof(buf),
                  "<DataArray type=\"%s\" Name=\"%s\" "
                  "NumberOfComponents=\"%d\" format=\"appended\" "
                  "offset=\"%llu\"/>\n",
                  dtype, name, ncomp, (unsigned long long)offset);
    xml += buf;
    blocks.push_back({(const char*)data, nbytes});
    offset += sizeof(uint64_t) + nbytes;
}

}  // namespace

// Write a single-piece .vtu with raw appended binary data.
// points: (n_points, 3) f64; cells: (n_cells, 3) int32 triangles.
// pd_*: point fields ((n_points,) f64 each); cd_*: cell fields.
// Returns 0 on success, nonzero errno-style code on failure.
int32_t tw_write_vtu(const char* path,
                     const double* points, int64_t n_points,
                     const int32_t* cells, int64_t n_cells,
                     const char* const* pd_names,
                     const double* const* pd_data, int32_t n_pd,
                     const char* const* cd_names,
                     const double* const* cd_data, int32_t n_cd) {
    std::string xml;
    xml.reserve(4096);
    std::vector<Block> blocks;
    uint64_t offset = 0;

    char buf[512];
    xml += "<?xml version=\"1.0\"?>\n"
           "<VTKFile type=\"UnstructuredGrid\" version=\"1.0\" "
           "byte_order=\"LittleEndian\" header_type=\"UInt64\">\n"
           "<UnstructuredGrid>\n";
    std::snprintf(buf, sizeof(buf),
                  "<Piece NumberOfPoints=\"%lld\" NumberOfCells=\"%lld\">\n",
                  (long long)n_points, (long long)n_cells);
    xml += buf;

    xml += "<Points>\n";
    append_block(xml, blocks, offset, "Float64", "Points", 3,
                 points, (uint64_t)n_points * 3 * sizeof(double));
    xml += "</Points>\n<Cells>\n";
    append_block(xml, blocks, offset, "Int32", "connectivity", 1,
                 cells, (uint64_t)n_cells * 3 * sizeof(int32_t));

    std::vector<int32_t> offs((size_t)n_cells);
    for (int64_t e = 0; e < n_cells; ++e) offs[(size_t)e] = (int32_t)(3 * (e + 1));
    append_block(xml, blocks, offset, "Int32", "offsets", 1,
                 offs.data(), (uint64_t)n_cells * sizeof(int32_t));

    std::vector<uint8_t> types((size_t)n_cells, 5);  // VTK_TRIANGLE
    append_block(xml, blocks, offset, "UInt8", "types", 1,
                 types.data(), (uint64_t)n_cells);
    xml += "</Cells>\n";

    xml += "<PointData>\n";
    for (int32_t f = 0; f < n_pd; ++f)
        append_block(xml, blocks, offset, "Float64", pd_names[f], 1,
                     pd_data[f], (uint64_t)n_points * sizeof(double));
    xml += "</PointData>\n<CellData>\n";
    for (int32_t f = 0; f < n_cd; ++f)
        append_block(xml, blocks, offset, "Float64", cd_names[f], 1,
                     cd_data[f], (uint64_t)n_cells * sizeof(double));
    xml += "</CellData>\n</Piece>\n</UnstructuredGrid>\n"
           "<AppendedData encoding=\"raw\">\n_";

    FILE* fp = std::fopen(path, "wb");
    if (!fp) return 1;
    if (std::fwrite(xml.data(), 1, xml.size(), fp) != xml.size()) {
        std::fclose(fp);
        return 2;
    }
    for (const Block& b : blocks) {
        const uint64_t size = b.size;
        if (std::fwrite(&size, sizeof(uint64_t), 1, fp) != 1 ||
            (size && std::fwrite(b.bytes, 1, size, fp) != size)) {
            std::fclose(fp);
            return 2;
        }
    }
    const char* tail = "\n</AppendedData>\n</VTKFile>\n";
    std::fwrite(tail, 1, std::strlen(tail), fp);
    return std::fclose(fp) == 0 ? 0 : 3;
}

// Legacy-format VTK mesh snapshot (GridOut::write_vtk parity).
// pts_xy: (n_points, 2) f64.
int32_t tw_write_mesh_vtk(const char* path,
                          const double* pts_xy, int64_t n_points,
                          const int32_t* cells, int64_t n_cells) {
    FILE* fp = std::fopen(path, "w");
    if (!fp) return 1;
    std::fprintf(fp,
                 "# vtk DataFile Version 3.0\n"
                 "Triangulation generated by tpuwave\nASCII\n"
                 "DATASET UNSTRUCTURED_GRID\nPOINTS %lld double\n",
                 (long long)n_points);
    for (int64_t p = 0; p < n_points; ++p)
        std::fprintf(fp, "%.12g %.12g 0\n", pts_xy[2 * p], pts_xy[2 * p + 1]);
    std::fprintf(fp, "CELLS %lld %lld\n", (long long)n_cells,
                 (long long)(4 * n_cells));
    for (int64_t e = 0; e < n_cells; ++e)
        std::fprintf(fp, "3 %d %d %d\n", cells[3 * e], cells[3 * e + 1],
                     cells[3 * e + 2]);
    std::fprintf(fp, "CELL_TYPES %lld\n", (long long)n_cells);
    for (int64_t e = 0; e < n_cells; ++e) std::fprintf(fp, "5\n");
    return std::fclose(fp) == 0 ? 0 : 3;
}

}  // extern "C"

"""The animated isosurface of the renderer's path-traced frame (BASELINE
config 5): marching cubes over the SDF of marching_cubes.comp, extracted
anew at each frame's time.

The domain is the fixed [0,32]^3 world box cut into grid^3 voxels (32^3
in the configuration). The density is a solid (-1) with three shapes
carved out by max(-sdf, d): a torus at (10,20,10) (radii 5 and 3), a box
at (10,10,10) (half-size 5) and a sphere at (10,26,10) of radius
8 |sin(0.3 t)|. A voxel's case sets bit i where corner i's density is below
the iso level 0; each edge the case's triangles name is cut where the
density crosses 0, by linear interpolation along the edge; each voxel owns
five triangle slots, and the surface is kept slot-major (all voxels' first
triangle, then their second, ...), unused slots zero. A vertex's normal is
the negated central difference of the density, normalized.

Where the shader leaves float32 arithmetic open or does otherwise, this
module follows the renderer's JAX package, so that the same time gives the
same triangles to the last bit:
- each length is `torch.linalg.vector_norm` over the last axis (the JAX
  package's `jnp.linalg.norm`), not a GLSL `length`;
- the interpolation is pa + (pb - pa) * clamp(t, 0, 1), with t =
  (iso - va) / (vb - va) and a denominator below 1e-12 in magnitude
  taken as 1e-12, where the shader mixes the corners unclamped;
- the lattice is the voxel index times the voxel size, the corner offsets
  times the voxel size added to each voxel's base;
- the gradient steps one world unit along each axis (the shader steps
  one voxel, the same at 32^3) and is clamped away from zero (1e-12)
  before the division;
- the slots are kept in voxel order per slot, where the shader appends
  with atomicAdd in whatever order its threads run.

The triangle table is the classic one of marching-cubes tables.glsl
(P. Bourke, "Polygonising a scalar field"): for each of the 256 cases the
edges of its triangles, three to a triangle, one hexadecimal digit an
edge."""

from __future__ import annotations

import functools

import numpy as np
import torch

SLOTS = 5  # triangle slots a voxel
DOMAIN = 32.0  # the world box's side
# Edge -> its two corners; corner i at offset CORNERS[i] in voxels.
EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7))
CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
TRIANGLES = (
    "", "083", "019", "183981", "12a", "08312a", "92a029", "2832a8a98", "3b2", "0b28b0",
    "19023b", "1b219b98b", "3a1ba3", "0a108a8ba", "3903b9ba9", "98aa8b", "478", "430734",
    "019847", "419471731", "12a847", "34730412a", "92a902847", "2a9297273794", "8473b2",
    "b47b24204", "90184723b", "47b94b9b2921", "3a13ba784", "1ba14b1047b4", "47890b9bab03",
    "47b4b99ba", "954", "954083", "054150", "854835315", "12a954", "30812a495", "52a542402",
    "2a5325354348", "95423b", "0b208b495", "05401523b", "21525828b485", "a3ba13954",
    "4950818a18ba", "54050b5bab03", "54858aa8b", "978579", "930953573", "078017157", "153357",
    "978957a12", "a12950530573", "802825857a52", "2a5253357", "7957893b2", "95797292027b",
    "23b018178157", "b21b17715", "958857a13a3b", "5705097b010aba0", "ba0b03a50807570", "ba57b5",
    "a65", "0835a6", "9015a6", "1831985a6", "165261", "165126308", "965906026", "598582526328",
    "23ba65", "b08b20a65", "01923b5a6", "5a61929b298b", "63b653513", "08b0b50515b6",
    "3b6036065059", "65969bb98", "5a6478", "43047365a", "1905a6847", "a65197173794",
    "612651478", "125526304347", "847905065026", "739794329596269", "3b2784a65", "5a647242027b",
    "01947823b5a6", "9219b294b7b45a6", "8473b53515b6", "51b5b610b7b404b", "059065036b63847",
    "65969b4797b9", "a4964a", "4a649a083", "a01a60640", "83181686461a", "149124264",
    "308129249264", "024426", "832824426", "a49a64b23", "08228b49a4a6", "3b201606461a",
    "64161a48121b8b1", "964936913b63", "8b1810b61914641", "3b6360064", "648b68", "7a678a89a",
    "0730a709a67a", "a671a7178180", "a67a71173", "126168189867", "269291679093739", "780706602",
    "732672", "23ba68a89867", "20727b09767a9a7", "1801781a767a23b", "b21b17a61671",
    "896867916b63136", "091b67", "7807063b0b60", "7b6", "76b", "308b76", "019b76", "819831b76",
    "a126b7", "12a3086b7", "2902a96b7", "6b72a3a83a98", "723627", "708760620", "276237019",
    "162186198876", "a76a17137", "a7617a187108", "03707a0a96a7", "76a7a88a9", "684b86",
    "36b306046", "86b846901", "946963931b36", "6846b82a1", "12a30b06b046", "4b846b0292a9",
    "a93a32943b36463", "823842462", "042462", "190234246438", "194142246", "8138618466a1",
    "a10a06604", "4634386a3039a93", "a946a4", "49576b", "083495b76", "50154076b",
    "b76834354315", "954a1276b", "6b712a083495", "76b54a42a402", "348354325a52b76", "723762549",
    "954086062687", "362376150540", "628687218485158", "954a16176137", "16a176107870954",
    "40a4a503a6a737a", "76a7a854a48a", "6956b9b89", "36b063056095", "0b805b01556b", "6b3635531",
    "12a95b9b8b56", "0b306b09656912a", "b85b56805a52025", "6b36352a3a53", "589528562382",
    "956960062", "158180568382628", "156216", "13616a386569896", "a10a06950560", "03856a",
    "a56", "b5a75b", "b5ab75830", "5b75ab190", "a75ab7981831", "b12b71751", "08312717572b",
    "9759279022b7", "75272b592328982", "25a235375", "820852875a25", "9015a35373a2",
    "982921872a25752", "135375", "087071175", "903935537", "987597", "5845a8ab8",
    "5045b05abb30", "01984a8aba45", "ab4a45b34941314", "2512852b8458", "04b0b345b2b151b",
    "0250592b5458b85", "9452b3", "25a352345384", "5a2524420", "3a235a385458019", "5a2524192942",
    "845853351", "045105", "845853905035", "945", "4b749b9ab", "0834979b79ab", "1ab1b414074b",
    "3143481a474bab4", "4b79b492b912", "9749b791b2b1083", "b74b42240", "b74b42834324",
    "29a279237749", "9a7974a27870207", "37a3a274a1a040a", "1a2874", "491417713", "491417081871",
    "403743", "487", "9a8ab8", "30939bb9a", "01a0a88ab", "31ab3a", "12b1b99b8", "30939b1292b9",
    "02b80b", "32b", "23828aa89", "9a2092", "23828a0181a8", "1a2", "138918", "091", "038", "",
)


@functools.lru_cache(maxsize=None)
def table() -> np.ndarray:
    """(256, 16) int64: each case's edges, -1 after its last."""
    out = np.full((256, 16), -1, np.int64)
    for case, edges in enumerate(TRIANGLES):
        out[case, :len(edges)] = [int(e, 16) for e in edges]
    return out


def _vec(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _length(v):
    return torch.linalg.vector_norm(v, dim=-1)


def density(p: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
    """The SDF's density at points p (..., 3) and time t (float32)."""
    dev = p.device
    d = torch.full(p.shape[:-1], -1.0, dtype=torch.float32, device=dev)
    q = p - _vec((10.0, 20.0, 10.0), dev)
    torus = torch.stack([_length(q[..., [0, 2]]) - 5.0, q[..., 1]], dim=-1)
    d = torch.maximum(-(_length(torus) - 3.0), d)
    b = (p - _vec((10.0, 10.0, 10.0), dev)).abs() - _vec((5.0, 5.0, 5.0), dev)
    box = _length(torch.clamp(b, min=0.0)) + torch.clamp(
        torch.maximum(b[..., 0], torch.maximum(b[..., 1], b[..., 2])), max=0.0)
    d = torch.maximum(-box, d)
    radius = 8.0 * torch.abs(torch.sin(time * 0.3))
    return torch.maximum(-(_length(p - _vec((10.0, 26.0, 10.0), dev)) - radius), d)


def extract(time, grid: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The surface at `time` (a float32): (positions (5V, 3, 3), normals
    (5V, 3, 3), live (5V,) bool), slot-major over the V = grid^3 voxels in
    x-major order; a dead slot's corners are zero."""
    dev = torch.device(device)
    time = torch.as_tensor(np.float32(time), device=dev)
    size = DOMAIN / grid
    axis = torch.arange(grid + 1, dtype=torch.float32, device=dev) * size
    lattice = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), dim=-1)
    field = density(lattice, time)
    idx = torch.arange(grid, device=dev)
    vx, vy, vz = (a.reshape(-1) for a in torch.meshgrid(idx, idx, idx, indexing="ij"))
    corner_d = torch.stack([field[vx + cx, vy + cy, vz + cz] for cx, cy, cz in CORNERS], -1)
    case = torch.zeros(vx.shape, dtype=torch.int64, device=dev)
    for i in range(8):
        case = case | torch.where(corner_d[:, i] < 0.0, 1 << i, 0)
    base = torch.stack([vx, vy, vz], dim=-1).to(torch.float32) * size
    offsets = _vec((np.asarray(CORNERS, np.float32) * size).tolist(), dev)
    cuts = []
    for a, b in EDGES:
        pa, pb = base + offsets[a], base + offsets[b]
        da, db = corner_d[:, a], corner_d[:, b]
        t = (0.0 - da) / torch.where((db - da).abs() < 1e-12, 1e-12, db - da)
        cuts.append(pa + (pb - pa) * torch.clamp(t, 0.0, 1.0)[:, None])
    cuts = torch.stack(cuts, dim=1)  # (V, 12, 3)
    edges = torch.as_tensor(table(), device=dev)[case]  # (V, 16)
    voxel = torch.arange(case.shape[0], device=dev)[:, None]
    pos, live = [], []
    for s in range(SLOTS):
        e = edges[:, 3 * s:3 * s + 3]
        ok = e[:, 0] >= 0
        pos.append(torch.where(ok[:, None, None], cuts[voxel, e.clamp(min=0)], 0.0))
        live.append(ok)
    pos = torch.cat(pos)
    flat = pos.reshape(-1, 3)
    grad = []
    for k in range(3):
        step = _vec(tuple(float(i == k) for i in range(3)), dev)
        grad.append(density(flat + step, time) - density(flat - step, time))
    grad = torch.stack(grad, dim=-1)
    normals = -grad / torch.clamp(_length(grad)[..., None], min=1e-12)
    return pos, normals.reshape(pos.shape), torch.cat(live)

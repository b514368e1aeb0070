"""Minimal PLY triangle-mesh reader (ascii and binary_little_endian) and
ASCII writer on NumPy (the port's own copy of data_gen_tpu/meshio.py; the
reference loads the DTU surface meshes with trimesh,
data_gen/dtu_mvs/surf_from_mvs.py:65)."""

import numpy as np

_PLY_TYPES = {
    'char': 'i1', 'uchar': 'u1', 'short': 'i2', 'ushort': 'u2',
    'int': 'i4', 'uint': 'u4', 'float': 'f4', 'double': 'f8',
    'int8': 'i1', 'uint8': 'u1', 'int16': 'i2', 'uint16': 'u2',
    'int32': 'i4', 'uint32': 'u4', 'float32': 'f4', 'float64': 'f8',
}


def read_ply(path):
    """Returns (vertices (V,3) float32, faces (F,3) int64)."""
    with open(path, 'rb') as h:
        magic = h.readline().strip()
        if magic != b'ply':
            raise ValueError("Not a PLY file: %s" % path)
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) | list-prop])
        while True:
            line = h.readline().decode('ascii').strip()
            if line == 'end_header':
                break
            parts = line.split()
            if not parts or parts[0] == 'comment':
                continue
            if parts[0] == 'format':
                fmt = parts[1]
            elif parts[0] == 'element':
                elements.append([parts[1], int(parts[2]), []])
            elif parts[0] == 'property':
                if parts[1] == 'list':
                    elements[-1][2].append(
                        ('list', _PLY_TYPES[parts[2]],
                         _PLY_TYPES[parts[3]], parts[4]))
                else:
                    elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]]))
        if fmt not in ('ascii', 'binary_little_endian'):
            raise ValueError("Unsupported PLY format: %s" % fmt)
        vertices, faces = None, None
        if fmt == 'ascii':
            lines = h.read().decode('ascii').split('\n')
            li = 0
            for name, count, props in elements:
                rows = lines[li:li + count]
                li += count
                if name == 'vertex':
                    arr = np.array(
                        [r.split()[:len(props)] for r in rows], np.float32)
                    names = [p[0] for p in props]
                    ix = [names.index(c) for c in ('x', 'y', 'z')]
                    vertices = arr[:, ix]
                elif name == 'face':
                    faces = np.array(
                        [r.split()[1:4] for r in rows], np.int64)
        else:
            for name, count, props in elements:
                if name == 'vertex':
                    dt = np.dtype([(p[0], '<' + p[1]) for p in props])
                    arr = np.frombuffer(h.read(dt.itemsize * count), dt)
                    vertices = np.stack(
                        [arr['x'], arr['y'], arr['z']], axis=1).astype(
                            np.float32)
                elif name == 'face':
                    if len(props) != 1 or props[0][0] != 'list':
                        raise ValueError(
                            "Only pure list-property faces supported")
                    cnt_dt = np.dtype('<' + props[0][1])
                    idx_dt = np.dtype('<' + props[0][2])
                    faces = np.empty((count, 3), np.int64)
                    for i in range(count):
                        k = int(np.frombuffer(
                            h.read(cnt_dt.itemsize), cnt_dt)[0])
                        idx = np.frombuffer(
                            h.read(idx_dt.itemsize * k), idx_dt)
                        if k != 3:
                            raise ValueError("Non-triangular face in %s"
                                             % path)
                        faces[i] = idx[:3]
                else:
                    # Skip unknown fixed-size elements
                    dt = np.dtype([(p[0], '<' + p[1]) for p in props])
                    h.read(dt.itemsize * count)
    if vertices is None or faces is None:
        raise ValueError("PLY missing vertex or face element: %s" % path)
    return vertices, faces


def write_ply(path, vertices, faces):
    """ASCII PLY writer (for tests and debugging)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int64)
    with open(path, 'w') as h:
        h.write('ply\nformat ascii 1.0\n')
        h.write('element vertex %d\n' % len(vertices))
        h.write('property float x\nproperty float y\nproperty float z\n')
        h.write('element face %d\n' % len(faces))
        h.write('property list uchar int vertex_indices\n')
        h.write('end_header\n')
        for v in vertices:
            h.write('%g %g %g\n' % tuple(v))
        for f in faces:
            h.write('3 %d %d %d\n' % tuple(f))

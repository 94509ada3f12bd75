"""URDF emission from estimated links + joints.

Frame conventions mirror the reference writer exactly
(reference/PointCloud/compute_joints.py:274-388):

- per-link transform = mean of member-cluster matrices at step 0;
- the child link's visual origin offset = child frame translation minus
  the joint's global position (root uses its own frame translation);
- joint origin xyz = joint global pos in the parent frame + the parent's
  own visual offset; joint axis = global axis rotated into the parent
  frame; joint rpy = euler of parent->child relative rotation;
- revolute joints with +-pi limits, unit mass, diagonal 0.1 inertia,
  jet-colormap materials.

Port of autourdf_tpu.urdf.writer, with the jet colour ramp written out here
instead of matplotlib's.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
from scipy.spatial.transform import Rotation as ScipyRot

from ..joints.screw import JointEstimate
from ..structure.coord_map import CoordMap
from ..structure.tree import LinkNode


# matplotlib's "jet": piecewise-linear ramps (knot, value) per channel,
# sampled into a 256-entry table that a float in [0, 1] indexes by floor.
_JET_KNOTS = (
    ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
    ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
)
_JET_ENTRIES = 256


def jet(x: float) -> tuple[float, float, float, float]:
    """RGBA of matplotlib's ``colormaps["jet"](x)`` for a float in [0, 1]."""
    idx = min(max(int(x * _JET_ENTRIES), 0), _JET_ENTRIES - 1)
    pos = idx / (_JET_ENTRIES - 1)
    rgb = tuple(float(np.interp(pos, [k for k, _ in ch], [v for _, v in ch]))
                for ch in _JET_KNOTS)
    return rgb + (1.0,)


def link_transforms_at_step(
    cm: CoordMap, links: list[LinkNode], step: int = 0
) -> dict[int, np.ndarray]:
    """Per-link mean of member cluster matrices (element-wise mean, as the
    reference does at compute_joints.py:281-284)."""
    out = {}
    for link in links:
        members = sorted(link.cluster_idx)
        out[link.id] = np.mean(cm.matrices[step, members], axis=0)
    return out


def write_urdf(
    links: list[LinkNode],
    joints: list[JointEstimate],
    cm: CoordMap,
    output_file: str,
    mesh_dir: str = "",
    robot_name: str = "estimated_robot",
    step: int = 0,
) -> str:
    robot = ET.Element("robot", name=robot_name)
    link_T = link_transforms_at_step(cm, links, step)

    link_pos_local: dict[int, np.ndarray] = {}
    for j in joints:
        child_frame = link_T[j.child_link]
        link_pos_local[j.child_link] = child_frame[:3, 3] - j.global_pos[:3]

    # key by link id: ids need not be contiguous after static-joint pruning
    colors = {link.id: jet(i / len(links)) for i, link in enumerate(links)}

    for link in links:
        name = f"link_{link.id}"
        el = ET.SubElement(robot, "link", name=name)
        T = link_T[link.id]
        if link.parent_id is None:
            link_pos_local[link.id] = T[:3, 3]
        xyz = " ".join(map(str, link_pos_local[link.id]))
        rpy = "0.0 0.0 0.0"
        mesh_file = os.path.join(mesh_dir, f"{link.id:04}.stl")

        visual = ET.SubElement(el, "visual")
        ET.SubElement(visual, "origin", xyz=xyz, rpy=rpy)
        geom = ET.SubElement(visual, "geometry")
        ET.SubElement(geom, "mesh", filename=mesh_file, scale="1 1 1")
        mat = ET.SubElement(visual, "material", name=f"material_{link.id}")
        rgba = " ".join(map(str, tuple(colors[link.id][:3]) + (1,)))
        ET.SubElement(mat, "color", rgba=rgba)

        collision = ET.SubElement(el, "collision")
        ET.SubElement(collision, "origin", xyz=xyz, rpy=rpy)
        geom = ET.SubElement(collision, "geometry")
        ET.SubElement(geom, "mesh", filename=mesh_file, scale="1 1 1")

        inertial = ET.SubElement(el, "inertial")
        ET.SubElement(inertial, "origin", xyz=xyz, rpy=rpy)
        ET.SubElement(inertial, "mass", value="1.0")
        ET.SubElement(
            inertial, "inertia",
            ixx="0.1", ixy="0.0", ixz="0.0", iyy="0.1", iyz="0.0", izz="0.1",
        )

    for j in joints:
        jel = ET.SubElement(
            robot, "joint", name=f"joint_{j.child_link}", type="revolute"
        )
        ET.SubElement(jel, "parent", link=f"link_{j.parent_link}")
        ET.SubElement(jel, "child", link=f"link_{j.child_link}")

        parent_T = link_T[j.parent_link]
        child_T = link_T[j.child_link]

        gp = np.append(j.global_pos[:3], 1.0)
        local_pos = np.linalg.inv(parent_T) @ gp
        origin_xyz = " ".join(
            map(str, local_pos[:3] + link_pos_local[j.parent_link])
        )

        local_axis = np.linalg.inv(parent_T[:3, :3]) @ j.global_axis[:3]
        local_axis = local_axis / max(np.linalg.norm(local_axis), 1e-12)

        rel_rot = np.linalg.inv(parent_T[:3, :3]) @ child_T[:3, :3]
        rpy_vals = ScipyRot.from_matrix(rel_rot).as_euler("xyz")
        ET.SubElement(
            jel, "origin", xyz=origin_xyz, rpy=" ".join(map(str, rpy_vals))
        )
        ET.SubElement(jel, "axis", xyz=" ".join(map(str, local_axis)))
        ET.SubElement(
            jel, "limit", effort="100", velocity="100",
            lower="-3.14159", upper="3.14159",
        )

    tree = ET.ElementTree(robot)
    ET.indent(tree, space="  ", level=0)
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    tree.write(output_file, encoding="utf-8", xml_declaration=True)
    return output_file

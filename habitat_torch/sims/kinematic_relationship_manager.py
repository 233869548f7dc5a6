"""Kinematic parent/child transform graph (port of
``habitat_tpu/sims/kinematic_relationship_manager.py``; reference
habitat-lab/habitat/sims/habitat_simulator/kinematic_relationship_manager.py:
in kinematic mode stacked or contained objects follow their parents;
RearrangeSim.step applies relations each step :919-921).

- ``apply_relations`` / ``apply_relations_rotating``: the batched form, torch
  on the device of their inputs. An (N, O) parent index array (-1 = world);
  children follow their parents' moves, with the parents' yaw deltas in the
  rotating form. A gather per chain level, no graph walk, no host sync.
- ``RelationshipGraph``: parent/child maps with relation types, root
  parents, a human-readable forest (reference :20-155).
- ``KinematicRelationshipManager``: transform snapshots per object, relation
  snapshots, ``apply_relationships_snapshot`` (each child keeps its offset
  in its parent's frame, root first so chains compose), relations inferred
  from geometry (reference :157-486). Host numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from habitat_torch.sims.sim_utilities import ontop

# -- batched form ---------------------------------------------------------------


def apply_relations(obj_pos: torch.Tensor, parent: torch.Tensor, parent_delta: torch.Tensor,
                    iterations: int = 2) -> torch.Tensor:
    """(N, O, 3) positions, (N, O) parent indices (-1 = world) and (N, O, 3)
    own moves this step -> positions moved by what each object inherits.

    total(obj) = own(obj) + total(parent), over ``iterations`` chain levels;
    callers already applied each object's own move."""
    safe = parent.clamp_min(0).long()
    has_parent = (parent >= 0)[..., None]
    total = parent_delta
    for _ in range(iterations):
        inherited = torch.gather(total, 1, safe[..., None].expand_as(total))
        total = parent_delta + torch.where(has_parent, inherited, 0.0)
    return obj_pos + (total - parent_delta)


def apply_relations_rotating(obj_pos: torch.Tensor, parent: torch.Tensor, parent_pos_prev: torch.Tensor,
                             parent_pos_new: torch.Tensor, parent_dyaw: torch.Tensor) -> torch.Tensor:
    """SE(2)-relative application: each child keeps its offset in its
    parent's frame, so a turning parent swings its children about it
    (reference _apply_relations_recursive:358 composes full SE(3)
    transforms; the yaw form covers upright rearrange objects). Positions
    (N, O, 3) before and after the parents' move, (N, O) yaw deltas."""
    safe = parent.clamp_min(0).long()
    has_parent = (parent >= 0)[..., None]
    idx3 = safe[..., None].expand_as(obj_pos)
    p_prev = torch.gather(parent_pos_prev, 1, idx3)
    p_new = torch.gather(parent_pos_new, 1, idx3)
    dyaw = torch.gather(parent_dyaw, 1, safe)
    off = obj_pos - p_prev
    c, s = torch.cos(dyaw), torch.sin(dyaw)
    off_rot = torch.stack([c * off[..., 0] + s * off[..., 2], off[..., 1], -s * off[..., 0] + c * off[..., 2]], dim=-1)
    return torch.where(has_parent, p_new + off_rot, obj_pos)


# -- host graph and manager -------------------------------------------------------


class RelationshipGraph:
    """Parent/child maps with relation types (reference :20)."""

    def __init__(self):
        self.obj_to_children: Dict[int, List[int]] = {}
        self.obj_to_parents: Dict[int, int] = {}
        self.relation_types: Dict[Tuple[int, int], str] = {}

    def add_relation(self, parent: int, child: int, rel_type: str = "ontop") -> None:
        if parent == child:
            raise ValueError(f"object {child} cannot be its own parent")
        if (parent, child) not in self.relation_types:
            if child in self.obj_to_parents:
                # one parent per child: re-parent
                self.remove_relation(self.obj_to_parents[child], child)
            self.obj_to_children.setdefault(parent, []).append(child)
            self.obj_to_parents[child] = parent
        self.relation_types[(parent, child)] = rel_type

    def remove_relation(self, parent: int, child: int) -> None:
        self.relation_types.pop((parent, child), None)
        if self.obj_to_parents.get(child) == parent:
            del self.obj_to_parents[child]
        if parent in self.obj_to_children:
            self.obj_to_children[parent] = [c for c in self.obj_to_children[parent] if c != child]
            if not self.obj_to_children[parent]:
                del self.obj_to_children[parent]

    def remove_obj_relations(self, obj: int, parents_only: bool = False) -> None:
        """Detach an object (reference :82), e.g. when it is grasped."""
        if obj in self.obj_to_parents:
            self.remove_relation(self.obj_to_parents[obj], obj)
        if not parents_only:
            for c in list(self.obj_to_children.get(obj, [])):
                self.remove_relation(obj, c)

    def get_parent(self, child: int) -> Optional[int]:
        return self.obj_to_parents.get(child)

    def get_children(self, parent: int) -> List[int]:
        return list(self.obj_to_children.get(parent, []))

    def get_root_parents(self) -> List[int]:
        """Parents that are nobody's children (reference :101)."""
        return [p for p in self.obj_to_children if p not in self.obj_to_parents]

    def get_human_readable_relationship_forest(self, names: Optional[Dict[int, str]] = None) -> List[str]:
        """The forest as indented lines (reference :114)."""
        names = names or {}
        lines: List[str] = []

        def walk(obj: int, depth: int) -> None:
            rel = ""
            if obj in self.obj_to_parents:
                rel = f" [{self.relation_types[(self.obj_to_parents[obj], obj)]}]"
            lines.append("  " * depth + f"- {names.get(obj, str(obj))}{rel}")
            for c in self.obj_to_children.get(obj, []):
                walk(c, depth + 1)

        for root in self.get_root_parents():
            walk(root, 0)
        return lines

    def to_parent_array(self, num_objects: int) -> np.ndarray:
        out = np.full((num_objects,), -1, np.int32)
        for c, p in self.obj_to_parents.items():
            if 0 <= c < num_objects:
                out[c] = p
        return out


class KinematicRelationshipManager:
    """Owns the graph, keeps each object's (position, yaw) snapshot and
    re-applies parent-relative offsets after parents move (reference :157)."""

    def __init__(self, num_objects: int):
        self.relationship_graph = RelationshipGraph()
        self.num_objects = num_objects
        self.prev_snapshot: Dict[int, Tuple[np.ndarray, float]] = {}

    def initialize_from_obj_state(self, centers: np.ndarray, sizes: np.ndarray,
                                  yaws: Optional[Sequence[float]] = None) -> None:
        """Infer ontop relations from the boxes (reference
        initialize_from_dynamic_ontop:224) and take the snapshots."""
        for i in range(len(centers)):
            for j in range(len(centers)):
                if i != j and ontop(centers[i], sizes[i], centers[j], sizes[j]):
                    self.relationship_graph.add_relation(j, i, "ontop")
        self.update_snapshots(centers, yaws)

    initialize_from_dynamic_ontop = initialize_from_obj_state

    def update_snapshots(self, centers: np.ndarray, yaws: Optional[Sequence[float]] = None) -> None:
        yaws = yaws if yaws is not None else [0.0] * len(centers)
        self.prev_snapshot = {i: (np.asarray(centers[i], np.float64).copy(), float(yaws[i]))
                              for i in range(len(centers))}

    def get_relations_snapshot(self) -> Dict[int, Dict[int, str]]:
        """parent -> {child: relation type} over the forest, depth first
        (reference get_relations_snapshot:293)."""
        out: Dict[int, Dict[int, str]] = {}

        def walk(obj: int) -> None:
            kids = self.relationship_graph.get_children(obj)
            if kids:
                out[obj] = {c: self.relationship_graph.relation_types[(obj, c)] for c in kids}
            for c in kids:
                walk(c)

        for root in self.relationship_graph.get_root_parents():
            walk(root)
        return out

    def apply_relationships_snapshot(self, centers: np.ndarray, yaws: Optional[Sequence[float]] = None) -> np.ndarray:
        """Parents moved since the last snapshot -> children moved so each
        keeps its parent-frame offset, turns included, root first so chains
        compose (reference apply_relationships_snapshot:398)."""
        yaws = yaws if yaws is not None else [0.0] * len(centers)
        out = np.array(centers, np.float64, copy=True)

        def walk(obj: int, inherited_dyaw: float) -> None:
            # a parent's turn turns its subtree: yaw deltas accumulate root first
            p_prev, y_prev = self.prev_snapshot.get(obj, (out[obj], float(yaws[obj])))
            dy = (float(yaws[obj]) - y_prev) + inherited_dyaw
            for c in self.relationship_graph.get_children(obj):
                off = out[c] - p_prev
                cy, sy = np.cos(dy), np.sin(dy)
                out[c] = out[obj] + np.array([cy * off[0] + sy * off[2], off[1], -sy * off[0] + cy * off[2]])
                walk(c, dy)

        for root in self.relationship_graph.get_root_parents():
            walk(root, 0.0)
        return out

    def apply_relations(self, obj_pos: torch.Tensor, parent_delta: torch.Tensor) -> torch.Tensor:
        """The batched form over the current graph, on ``obj_pos``'s device."""
        parent = torch.as_tensor(self.relationship_graph.to_parent_array(self.num_objects),
                                 device=obj_pos.device)[None].expand(obj_pos.shape[:2])
        return apply_relations(obj_pos, parent, parent_delta)

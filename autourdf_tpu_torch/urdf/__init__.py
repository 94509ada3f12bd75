from .writer import jet, link_transforms_at_step, write_urdf

__all__ = ["write_urdf", "link_transforms_at_step", "jet"]

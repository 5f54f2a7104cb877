from .export import export_pose_model, load_exported

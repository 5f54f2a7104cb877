"""Multi-view stages (port of cosypose_tpu/multiview/): RANSAC candidate
matching, object-level bundle adjustment and the host matching library."""

"""Multi-view stages (port of cosypose_tpu/multiview/): RANSAC candidate
matching, object-level bundle adjustment and the host matching library."""

from .matching_cext import (
    make_ransac_infos,
    find_ransac_inliers,
    scatter_argmin,
    expand_ids_for_symmetry,
)
from .ransac import multiview_candidate_matching
from .bundle_adjustment import MultiviewRefinement, make_view_groups

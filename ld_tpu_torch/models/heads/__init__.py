from .atss_gfl_head import ATSSGFLHead, LDATSSHead
from .cascade_roi_head import CascadeRoIHead
from .cascade_rpn_head import CascadeRPNHead
from .classic_heads import ATSSHead, FCOSHead, NASFCOSHead
from .fcos_gfl_head import FCOSGFLHead, LDFCOSCompareHead, LDFCOSHead
from .fovea_head import FoveaHead
from .free_anchor_head import FreeAnchorRetinaHead
from .fsaf_head import FSAFHead
from .gfl_head import GFLHead
from .gfocal_head import GFocalHead
from .grid_point_roi import GridRoIHead, PointRendRoIHead
from .guided_anchor_head import GARetinaHead, GARPNHead
from .htc_roi_head import HybridTaskCascadeRoIHead, SCNetRoIHead
from .ld_gflv2 import IMv2Head, LDv2Head
from .ld_head import IMHead, LDHead
from .paa_head import PAAHead
from .pisa_heads import PISARetinaHead, PISARoIHead, PISASSDHead
from .reppoints_head import RepPointsHead
from .retina_gfl_head import LDRetinaHead, RetinaGFLHead
from .retina_head import RetinaHead, RetinaSepBNHead
from .roi_head import StandardRoIHead, TridentRoIHead
from .roi_variants import (DoubleHeadRoIHead, DynamicRoIHead,
                           MaskScoringRoIHead)
from .rpn_head import RPNHead
from .sabl_retina_head import SABLRetinaHead
from .sabl_roi_head import CascadeSABLRoIHead, SABLRoIHead
from .ssd_head import SSDHead
from .tood_head import TOODHead
from .vfnet_head import VFNetHead
from .yolo_head import YOLOV3Head, YOLOV3Neck

__all__ = ['GFLHead', 'IMHead', 'LDHead', 'GFocalHead', 'LDv2Head',
           'IMv2Head', 'ATSSGFLHead', 'LDATSSHead', 'FCOSGFLHead',
           'LDFCOSHead', 'LDFCOSCompareHead', 'RetinaGFLHead',
           'LDRetinaHead', 'RetinaHead', 'RetinaSepBNHead', 'FCOSHead',
           'ATSSHead', 'RPNHead', 'StandardRoIHead', 'CascadeRoIHead',
           'HybridTaskCascadeRoIHead', 'VFNetHead', 'GARetinaHead',
           'GARPNHead', 'RepPointsHead', 'FoveaHead', 'SSDHead',
           'MaskScoringRoIHead', 'PAAHead', 'FSAFHead',
           'FreeAnchorRetinaHead', 'SABLRetinaHead', 'SABLRoIHead',
           'CascadeSABLRoIHead', 'GridRoIHead', 'PointRendRoIHead',
           'NASFCOSHead', 'PISARetinaHead', 'PISARoIHead', 'PISASSDHead',
           'SCNetRoIHead', 'DoubleHeadRoIHead', 'DynamicRoIHead',
           'CascadeRPNHead', 'TOODHead', 'YOLOV3Head', 'YOLOV3Neck',
           'TridentRoIHead']

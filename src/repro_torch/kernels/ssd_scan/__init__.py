from .ops import state_scan
from .kernel import ssd_state_scan, ssd_state_scan_plain
from .ref import ssd_state_scan_ref

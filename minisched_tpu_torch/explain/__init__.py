from .annotation import FILTER_RESULT_KEY, FINAL_SCORE_RESULT_KEY, SCORE_RESULT_KEY  # noqa: F401
from .resultstore import ResultStore  # noqa: F401

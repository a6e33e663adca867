"""Annotation keys for per-decision scheduling results (reference
scheduler/plugin/annotation/annotation.go:5-9 — same keys for parity)."""

FILTER_RESULT_KEY = "scheduler-simulator/filter-result"
SCORE_RESULT_KEY = "scheduler-simulator/score-result"
FINAL_SCORE_RESULT_KEY = "scheduler-simulator/finalscore-result"

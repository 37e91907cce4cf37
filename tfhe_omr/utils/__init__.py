"""Timing, CSV records and size accounting (SURVEY.md §5 aux subsystems)."""

from tfhe_omr.utils.timing import StageTimer, TimingRecord, write_csv

__all__ = ["StageTimer", "TimingRecord", "write_csv"]

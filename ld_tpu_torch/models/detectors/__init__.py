from .single_stage import SingleStageDetector

__all__ = ['SingleStageDetector']

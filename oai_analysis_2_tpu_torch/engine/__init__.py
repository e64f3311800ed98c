from oai_analysis_2_tpu_torch.engine.segmenter import Segmenter3DInPatchClassWise

__all__ = ["Segmenter3DInPatchClassWise"]

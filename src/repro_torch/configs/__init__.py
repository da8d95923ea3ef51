"""Model configurations served by the port (copies of ``repro.configs``):
the ten assigned LM archs and the paper's own MLPs."""
from . import (qwen2_vl_2b, smollm_360m, h2o_danube_1_8b, glm4_9b,
               codeqwen1_5_7b, grok_1_314b, deepseek_v3_671b, hymba_1_5b,
               whisper_base, mamba2_1_3b, paper_mlps)
from .base import ArchConfig, get_config, list_configs

ALL = True

"""The LM substrate of the port (every family): layers, the Mamba2
mixer, MoE, MLA, the LM assembly and the conversion of reference
params."""

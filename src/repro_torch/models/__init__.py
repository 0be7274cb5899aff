"""The LM substrate of the port (dense and ssm families): layers, the
Mamba2 mixer, the LM assembly and the conversion of reference params."""

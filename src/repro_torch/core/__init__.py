"""The paper's primary contribution, ported to PyTorch:

- winograd:     F(2,3)/F(4,3) transforms and the GEMM formulation
- hybrid_conv:  the hybrid Spatial/Winograd PE with IS/WS dataflows
- isa:          the 128-bit instruction set (Fig. 2)
- compiler:     DNN graph + DSE plan -> instruction stream (Fig. 4 loops)
- executor:     validate-once schedule check + lowering to tensor ops
- runtime:      DRAM image + cached executor
- layouts:      WINO/SPAT data layouts + SAVE-side reorders (Sec. 4.3)
- perf_model:   the reference's planning models (DSE inputs)
- dse:          the 3-step design space exploration (Sec. 5.3)
"""

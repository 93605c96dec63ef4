"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a).

Sources live in ``repro_torch/csrc/``; :mod:`._build` compiles them with
``nvcc`` at first use. Ported so far: CSR SpMV (:mod:`.csr_spmv`) and DIA
SpMV (:mod:`.dia_spmv`); :mod:`.ops` binds them to the containers and
:mod:`.ref` holds their plain torch versions.
"""

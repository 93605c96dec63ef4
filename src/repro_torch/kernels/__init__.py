"""repro_torch.kernels — hand-written CUDA kernels for Hopper (sm_90a).

Sources live in ``repro_torch/csrc/``; :mod:`._build` compiles them with
``nvcc`` at first use. Ported so far: the SpMV kernels of every format with
a Pallas kernel in the JAX package — CSR (:mod:`.csr_spmv`), DIA
(:mod:`.dia_spmv`), ELL (:mod:`.ell_spmv`), SELL-C-sigma (:mod:`.sell_spmv`)
and block-CSR SpMM (:mod:`.bsr_spmm`, which BSR SpMV calls with one
column); HYB composes the ELL and CSR kernels. The SpMM kernels of the
sparse-weight layer: CSR SpMM and SpMM_T (:mod:`.csr_spmm`), ELL SpMM_T
(:mod:`.ell_spmm`) and SELL SpMM_T (:mod:`.sell_spmm`); HYB SpMM_T composes
the ELL and CSR ones. :mod:`.ops` binds them to the containers and
:mod:`.ref` holds their plain torch versions.
"""

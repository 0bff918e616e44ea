#!/usr/bin/env python3
"""K1's and K2's cluster sizes on the card: the blocked Cholesky factor
(``csrc/chol_inv.cu``, K1) at the Kuu route shapes ([3, 384, 384],
[1, 1024, 1024]) and the NatGrad solve's ([20, 384, 384],
[10, 1024, 1024]) with 2-16 blocks a matrix, and K3 (``csrc/tri_inv.cu``)
beside it; then K2, the whole upper factor from G's lower triangle, at
the solve's shapes up to [2, 2048, 2048] with each cluster size its
launcher may take; each held against its plain version first.

    python3 tools/torch_chol_clusters.py [--k2-only]

Prints one JSON line per shape and cluster size: the clusters the card
holds at once (``cudaOccupancyMaxActiveClusters``), the profiler's device
ms per launch and the relative error against the plain version; and for
the wrapper's own cluster size (``cuda_linalg._cluster``,
``_upper_cluster``) the first cluster's phases of one launch in SM clock
cycles (``clock64``), panel by panel (K1 at the Kuu shapes, K2 at
[2, 1088, 1088] and [2, 2048, 2048]).  At the NatGrad shapes it also
times the pieces of the solve ``cuda_linalg.chol_right_solve_upper`` by
both routes, each by CUDA events: K2, K3 and the product; and the
reversal pass, K1, K3 and the product.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('torch_chol_clusters: needs a CUDA card', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepcgp_tpu_torch.ops import cuda_build, cuda_linalg as cl
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({'card': card, 'build': cuda_build.build(
        ('chol_inv', 'tri_inv'))}), flush=True)
    factor = cuda_build.function(
        'chol_inv', 'chol_factor_blocked',
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    most = cuda_build.function('chol_inv', 'chol_factor_max_clusters',
                               [ctypes.c_int] * 2)
    rng = np.random.RandomState(0)
    dev = torch.device('cuda')
    if '--k2-only' not in sys.argv:
        k1_lines(torch, cs, cl, cuda_build, factor, most, rng, dev, card)
    k2_lines(torch, cs, cl, cuda_build, rng, dev, card)
    return 0


def chain_phases(t, n, worker):
    """The first cluster's phases from a trace of 8 + 10 (n - 1) stamps:
    the chain's (first block) and, for K2, its second block's warp 0."""
    at = t[8:].reshape(n - 1, 10)
    phases = {
        'setup_cycles': int(t[1] - t[0]),
        'panel0_solve_cycles': int(t[2] - t[1]),
        'diag_wait_and_downdate': (at[:, 1] - at[:, 0]).tolist(),
        'diag_factor': (at[:, 3] - at[:, 1]).tolist(),
        'diag_publish': (at[:, 4] - at[:, 3]).tolist(),
        'diag_store': (at[:, 2] - at[:, 4]).tolist(),
        'rank0_barrier': (at[:, 7] - at[:, 2]).tolist(),
        'panel_cycles': np.diff(
            np.concatenate([at[:, 0], [at[-1, 7]]])).tolist(),
        'total_cycles': int(at[-1, 7] - t[0])}
    if worker:
        phases.update({
            'rank1_warp0_downdates': (at[:, 6] - at[:, 9]).tolist(),
            'rank1_col_wait_and_fetch': [
                int(a[8] - a[6]) if a[8] else None for a in at],
            'rank1_col_solve': [
                int(a[5] - a[8]) if a[8] else None for a in at]})
    else:
        phases.update({
            'col_wait_and_fetch_rank1': (at[:, 8] - at[:, 6]).tolist(),
            'col_solve_rank1': (at[:, 5] - at[:, 8]).tolist()})
    return phases


def k2_lines(torch, cs, cl, cuda_build, rng, dev, card):
    """K2 at the NatGrad solve's shapes and beyond K1's largest matrix,
    with each cluster size of ``cuda_linalg.upper_clusters``; its chain
    traced at [2, 1088, 1088] and [2, 2048, 2048]; the solve's pieces by
    both routes at the NatGrad shapes."""
    upper = cuda_build.function(
        'chol_inv', 'chol_upper_blocked',
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    traced = cuda_build.function(
        'chol_inv', 'chol_upper_blocked_traced',
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    most = cuda_build.function('chol_inv', 'chol_upper_max_clusters',
                               [ctypes.c_int] * 2)
    for b, M in ((20, 384), (10, 1024), (2, 1088), (10, 1088), (2, 2048)):
        D = cs.spd_batch(torch, rng, b, M, dev)
        G = torch.tril(D)
        Lp, Dp = cl.chol_upper_blocked_plain(G)
        n = M // cl.W
        for cluster in cl.upper_clusters(M):
            L = torch.empty_like(G)
            Dinv = G.new_empty(b, n, cl.W, cl.W)

            def run(L=L, Dinv=Dinv, cluster=cluster):
                stream = torch.cuda.current_stream().cuda_stream
                cuda_build.check(upper(G.data_ptr(), L.data_ptr(),
                                       Dinv.data_ptr(), b, M, cluster,
                                       stream), 'chol_upper_blocked')
            run()
            torch.cuda.synchronize()
            err = max(cs.rel(L, Lp), cs.rel(Dinv, Dp))
            print(json.dumps({
                'kernel': 'K2', 'shape': [b, M, M], 'cluster': cluster,
                'wrapper_cluster': cl._upper_cluster(M, b),
                'smem_bytes': cl.upper_plan(M, cluster)['smem_bytes'],
                'max_active_clusters': most(M, cluster),
                'rel_err_vs_plain': err, 'card': card,
                'k2_ms': cs.kernel_ms(torch, run,
                                      'chol_upper_cluster_kernel')}),
                flush=True)
            cs.check(err <= 1e-5, f'K2 [{b},{M},{M}] cluster {cluster}: {err}')
        if b == 2:
            trace = torch.zeros(8 + 10 * (n - 1), dtype=torch.int64,
                                device=dev)
            L = torch.empty_like(G)
            Dinv = G.new_empty(b, n, cl.W, cl.W)
            for _ in range(2):
                cuda_build.check(traced(
                    G.data_ptr(), L.data_ptr(), Dinv.data_ptr(), b, M,
                    cl._upper_cluster(M, b), trace.data_ptr(),
                    torch.cuda.current_stream().cuda_stream), 'traced')
            torch.cuda.synchronize()
            print(json.dumps({'kernel': 'K2', 'shape': [b, M, M],
                              'cluster': cl._upper_cluster(M, b),
                              'trace': chain_phases(trace.cpu().numpy(), n,
                                                    True),
                              'card': card}), flush=True)
        if (b, M) in ((20, 384), (10, 1024)):
            X = torch.tril(cs.spd_batch(torch, rng, b, M, dev))
            Lf, Df = cl.chol_upper_blocked(G)
            Lfinv = cl.tri_inv_blocked(Lf, Df)
            Gr = cl.reversed_sym_from_tril(G)

            def reversed_route():
                Lr, Dr = cl.chol_factor_blocked(cl.reversed_sym_from_tril(G))
                return X @ cl.tri_inv_blocked(Lr, Dr).flip(-1, -2).transpose(
                    -1, -2)
            pieces = {
                'k2_ms': cs.cuda_ms(torch, lambda: cl.chol_upper_blocked(G), 20),
                'k3_ms': cs.cuda_ms(torch, lambda: cl.tri_inv_blocked(Lf, Df), 20),
                'product_ms': cs.cuda_ms(
                    torch, lambda: X @ Lfinv.flip(-1, -2).transpose(-1, -2), 20),
                'route_ms': cs.cuda_ms(
                    torch, lambda: cl.chol_right_solve_upper(G, X), 20),
                'reversal_ms': cs.cuda_ms(
                    torch, lambda: cl.reversed_sym_from_tril(G), 20),
                'k1_ms': cs.cuda_ms(torch, lambda: cl.chol_factor_blocked(Gr), 20),
                'reversed_route_ms': cs.cuda_ms(torch, reversed_route, 20)}
            print(json.dumps({'kernel': 'K2', 'shape': [b, M, M],
                              'solve_pieces': pieces, 'card': card}),
                  flush=True)


def k1_lines(torch, cs, cl, cuda_build, factor, most, rng, dev, card):
    """K1 with 2-16 blocks a matrix at the Kuu and NatGrad shapes, its
    chain traced at the Kuu shapes, K3 beside it."""
    for b, M in ((3, 384), (1, 1024), (20, 384), (10, 1024)):
        D = cs.spd_batch(torch, rng, b, M, dev)
        Lp, Dp = cl.chol_factor_blocked_plain(D)
        for cluster in (2, 4, 8, 16) if b < 10 else (4, 8, 16):
            L = torch.empty_like(D)
            Dinv = D.new_empty(b, M // cl.W, cl.W, cl.W)

            def run(L=L, Dinv=Dinv, cluster=cluster):
                stream = torch.cuda.current_stream().cuda_stream
                cuda_build.check(factor(D.data_ptr(), L.data_ptr(),
                                        Dinv.data_ptr(), b, M, cluster,
                                        stream), 'chol_factor_blocked')
            run()
            torch.cuda.synchronize()
            err = max(cs.rel(L, Lp), cs.rel(Dinv, Dp))
            line = {'shape': [b, M, M], 'cluster': cluster,
                    'max_active_clusters': most(M, cluster),
                    'rel_err_vs_plain': err, 'card': card,
                    'k1_ms': cs.kernel_ms(torch, run,
                                          'chol_factor_cluster_kernel')}
            print(json.dumps(line), flush=True)
            cs.check(err <= 1e-5, f'K1 [{b},{M},{M}] cluster {cluster}: {err}')
        if b >= 10:
            continue
        n = M // cl.W
        trace = torch.zeros(8 + 10 * (n - 1), dtype=torch.int64, device=dev)
        traced = cuda_build.function(
            'chol_inv', 'chol_factor_blocked_traced',
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        L = torch.empty_like(D)
        Dinv = D.new_empty(b, n, cl.W, cl.W)
        for _ in range(2):
            cuda_build.check(traced(
                D.data_ptr(), L.data_ptr(), Dinv.data_ptr(), b, M,
                cl._cluster(M, b), trace.data_ptr(),
                torch.cuda.current_stream().cuda_stream), 'traced')
        torch.cuda.synchronize()
        print(json.dumps({'shape': [b, M, M], 'cluster': cl._cluster(M, b),
                          'trace': chain_phases(trace.cpu().numpy(), n, False),
                          'card': card}), flush=True)
        X = cl.tri_inv_blocked(Lp.contiguous(), Dp.contiguous())
        torch.cuda.synchronize()
        err = cs.rel(X, cl.tri_inv_blocked_plain(Lp, Dp))
        print(json.dumps({'shape': [b, M, M], 'k3_rel_err_vs_plain': err,
                          'k3_ms': cs.kernel_ms(
                              torch, lambda: cl.tri_inv_blocked(Lp, Dp),
                              'tri_inv_strip_kernel'),
                          'card': card}), flush=True)
        cs.check(err <= 1e-5, f'K3 [{b},{M},{M}]: {err}')


if __name__ == '__main__':
    sys.exit(main())

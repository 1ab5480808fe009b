"""Compiled backend for the proposal-batched DSE engine (DESIGN.md §15).

The batched greedy's per-step work is ~a hundred scalar float ops on a
handful of layers — far below the dispatch cost of *any* array runtime
(measured: numpy lockstep ~1x vs the grouped serial engine, XLA-CPU
0.2–0.5x; per-call/per-thunk overhead floors both). The only way to beat
the serial engines by the integer factors a batched `ask_batch(k)` wave
wants is to run the scalar recurrence at native speed: this module embeds
a C port of the serial engines — both ``_run_incremental`` (flat) and
``_run_incremental_grouped`` (class-grouped, wave-batched), with the same
per-proposal ``auto`` dispatch rule — and drives it over the B proposals
of a batch in one call through ``ctypes``.

Build strategy: the C source is compiled on first use with the system C
compiler (``cc``/``gcc``/``clang``) into a shared object cached under
``_build/`` next to this file, keyed by a hash of the source + compile
flags, so rebuilds happen only when the kernel changes. No compiler, a
failed compile, or ``REPRO_DSE_CKERNEL=0`` in the environment all degrade
gracefully: ``get_lib()`` returns None and callers fall back to the pure
numpy lockstep engine (``dse.py`` dispatches on availability).

Pattern rows (DESIGN.md §16): batches whose ``LayerVectors.t_scale`` is
set never reach this kernel — the dynamics-class key below compares the
six pre-pattern per-layer constants only, so ``_run_batch_dispatch``
routes patterned rows to the numpy lockstep engine (which consumes the
host-scaled ``omsm`` and stays bit-exact vs the serial engines).

Float contract — why the kernel is bit-exact vs the Python engines:

  * every float expression is the serial engine's, in the serial engine's
    evaluation order (``rate_of`` mirrors ``thr_of``/``rates_pre``; the
    ``(1 - s_eff) * m_dot`` numerator is precomputed by the *caller* in
    numpy so even that product's rounding is shared);
  * integer design state is int64; all int products stay < 2**53 (the
    ``throughput_vec`` invariant), so int->double conversions are exact
    and C's ``(double)s * md`` equals Python's exact-int-then-divide;
  * compiled with ``-ffp-contract=off``: GCC's default contraction would
    fuse ``a * b - c`` into FMA (one rounding instead of two) and break
    equality with numpy, which never fuses. No ``-ffast-math`` for the
    same reason.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_C_SRC = r"""
#include <math.h>
#include <stdlib.h>
#include <string.h>

typedef long long i64;
typedef unsigned char u8;

/* Eq. 1-2 for one layer: the serial engines' thr_of / the numpy engine's
   rates_pre, scalar-for-scalar. om = (1 - s_eff) * m_dot (precomputed by
   the caller in numpy so its rounding is shared with the Python path). */
static double rate_of(double om, double md, double mc, i64 s, i64 nn) {
    double t;
    if (mc == 0.0) return INFINITY;
    t = ceil(om / (double)nn);
    if (t < 1.0) t = 1.0;
    return ((double)s * md) / (mc * t);
}

/* ------------------------------------------------------------------ */
/* Flat engine: 1:1 port of dse.py _run_incremental                   */
/* ------------------------------------------------------------------ */

#define SYNC(i) do { \
    thr[i] = rate_of(om[i], m_dot[i], macs[i], spe[i], n[i]); \
    r_nh[i] = rate_of(om[i], m_dot[i], macs[i], spe[i], \
                      n[i] > 1 ? n[i] / 2 : 1); \
    r_sh[i] = rate_of(om[i], m_dot[i], macs[i], \
                      spe[i] > 1 ? spe[i] / 2 : 1, n[i]); \
} while (0)

/* One Eq. 4-5 pass against fixed lo — the flat engine's balance():
   ascending-layer scan, entry via the maintained one-halving rates,
   n-halvings-then-spe-halvings shrink chain (with the reference's
   retry-n-after-spe order), res_total accumulated per changed layer in
   ascending layer order. Appends (i, new_s, new_n) mutation rows and
   records (i, old_s, old_n) into ch_* for budget reverts.
   Returns changed count, or -1 on mutation-buffer overflow. */
static i64 f_balance(i64 L, double lo, i64 skip_idx, const u8 *skip_mask,
                     const double *om, const double *m_dot,
                     const double *macs, const double *unit,
                     i64 *spe, i64 *n,
                     double *thr, double *r_nh, double *r_sh,
                     double *res_total,
                     i64 *ch_i, i64 *ch_s, i64 *ch_n,
                     i64 *mut_pos, i64 *mut_s, i64 *mut_n,
                     i64 *mp, i64 M) {
    i64 nch = 0, i;
    for (i = 0; i < L; i++) {
        i64 s_i, n_i;
        if (skip_mask ? skip_mask[i] : (i == skip_idx)) continue;
        if (!((n[i] > 1 && r_nh[i] >= lo) || (spe[i] > 1 && r_sh[i] >= lo)))
            continue;
        s_i = spe[i];
        n_i = n[i];
        ch_i[nch] = i; ch_s[nch] = s_i; ch_n[nch] = n_i; nch++;
        for (;;) {
            if (n_i > 1 &&
                rate_of(om[i], m_dot[i], macs[i], s_i, n_i / 2) >= lo) {
                n_i /= 2;
                continue;
            }
            if (s_i > 1 &&
                rate_of(om[i], m_dot[i], macs[i], s_i / 2, n_i) >= lo) {
                s_i /= 2;
                continue;
            }
            break;
        }
        *res_total += (double)(s_i * n_i - spe[i] * n[i]) * unit[i];
        spe[i] = s_i;
        n[i] = n_i;
        SYNC(i);
        if (*mp >= M) return -1;
        mut_pos[*mp] = i; mut_s[*mp] = s_i; mut_n[*mp] = n_i; (*mp)++;
    }
    return nch;
}

static int run_flat(i64 L, i64 max_iters, double budget,
                    const double *om, const double *m_dot,
                    const double *macs, const double *unit,
                    const i64 *max_n, const i64 *max_spe,
                    i64 *spe, i64 *n,
                    double *res_out, double *fthr_out, double *theta_out,
                    double *trr, double *trc, i64 *tr_len,
                    i64 *mpos, i64 *ms, i64 *mn, i64 *mc, i64 M,
                    double *thr, double *r_nh, double *r_sh,
                    i64 *ch_i, i64 *ch_s, i64 *ch_n, u8 *prot) {
    i64 i, it, nch, row_mp, nrows = 0, mp = 0;
    double res_total = 0.0, theta, hi, f_thr;
    int broke = 0;
    for (i = 0; i < L; i++) {
        spe[i] = 1;
        n[i] = 1;
        thr[i] = rate_of(om[i], m_dot[i], macs[i], 1, 1);
        r_nh[i] = thr[i];
        r_sh[i] = thr[i];
        res_total += unit[i];   /* float(sum(unit)), same add order */
    }
    for (it = 0; it < max_iters; it++) {
        double cur_thr, cur_res, best_score, m_after, res_before, u;
        i64 slow, sl_s, sl_n, b_s, b_n;
        int have;
        cur_thr = thr[0];
        slow = 0;
        for (i = 1; i < L; i++)           /* first-minimum: thr.index(min) */
            if (thr[i] < cur_thr) { cur_thr = thr[i]; slow = i; }
        trr[it] = res_total;
        trc[it] = cur_thr;
        row_mp = mp;
        sl_s = spe[slow];
        sl_n = n[slow];
        u = unit[slow];
        cur_res = (double)(sl_s * sl_n) * u;
        have = 0;
        b_s = 0; b_n = 0; best_score = 0.0;
        if (sl_n < max_n[slow]) {         /* n-doubling first: wins ties */
            i64 n2 = sl_n * 2;
            double dres, sc;
            if (n2 > max_n[slow]) n2 = max_n[slow];
            dres = (double)(sl_s * n2) * u - cur_res;
            if (dres < 1e-9) dres = 1e-9;
            sc = (rate_of(om[slow], m_dot[slow], macs[slow], sl_s, n2)
                  - cur_thr) / dres;
            have = 1; b_s = sl_s; b_n = n2; best_score = sc;
        }
        if (sl_s < max_spe[slow]) {
            i64 s2 = sl_s * 2;
            double dres, sc;
            if (s2 > max_spe[slow]) s2 = max_spe[slow];
            dres = (double)(s2 * sl_n) * u - cur_res;
            if (dres < 1e-9) dres = 1e-9;
            sc = (rate_of(om[slow], m_dot[slow], macs[slow], s2, sl_n)
                  - cur_thr) / dres;
            if (!have || sc > best_score) {
                have = 1; b_s = s2; b_n = sl_n; best_score = sc;
            }
        }
        if (!have) {                      /* saturated: row stays, no muts */
            mc[it] = 0;
            nrows = it + 1;
            broke = 1;
            break;
        }
        res_before = res_total;
        res_total += (double)(b_s * b_n - sl_s * sl_n) * u;
        spe[slow] = b_s;
        n[slow] = b_n;
        SYNC(slow);
        if (mp >= M) return 1;
        mpos[mp] = slow; ms[mp] = b_s; mn[mp] = b_n; mp++;
        m_after = thr[0];
        for (i = 1; i < L; i++) if (thr[i] < m_after) m_after = thr[i];
        nch = f_balance(L, m_after * (1 + 1e-9), slow, 0,
                        om, m_dot, macs, unit, spe, n, thr, r_nh, r_sh,
                        &res_total, ch_i, ch_s, ch_n,
                        mpos, ms, mn, &mp, M);
        if (nch < 0) return 1;
        if (res_total > budget) {         /* revert growth + balance */
            i64 j;
            spe[slow] = sl_s;
            n[slow] = sl_n;
            SYNC(slow);
            for (j = 0; j < nch; j++) {
                i = ch_i[j];
                spe[i] = ch_s[j];
                n[i] = ch_n[j];
                SYNC(i);
            }
            res_total = res_before;
            mp = row_mp;                  /* muts[-1] = [] */
            mc[it] = 0;
            nrows = it + 1;
            broke = 1;
            break;
        }
        mc[it] = mp - row_mp;
    }
    if (!broke) nrows = max_iters;
    /* final literal Eq. 4 pass: trim, protect the bottleneck set */
    theta = thr[0];
    for (i = 1; i < L; i++) if (thr[i] < theta) theta = thr[i];
    hi = theta * (1 + 1e-9);
    for (i = 0; i < L; i++) prot[i] = (u8)(thr[i] <= hi);
    row_mp = mp;
    nch = f_balance(L, theta * (1 - 1e-12), -1, prot,
                    om, m_dot, macs, unit, spe, n, thr, r_nh, r_sh,
                    &res_total, ch_i, ch_s, ch_n, mpos, ms, mn, &mp, M);
    if (nch < 0) return 1;
    mc[nrows] = mp - row_mp;
    f_thr = thr[0];
    for (i = 1; i < L; i++) if (thr[i] < f_thr) f_thr = thr[i];
    *res_out = res_total;
    *fthr_out = f_thr;
    *theta_out = theta;
    *tr_len = nrows;
    return 0;
}

/* ------------------------------------------------------------------ */
/* Grouped engine: 1:1 port of dse.py _run_incremental_grouped        */
/* ------------------------------------------------------------------ */

typedef struct { i64 start, cnt, s, n; double r, rnh, rsh; } Grp;

typedef struct {
    i64 L, C;
    const i64 *pos;       /* member positions, class-major; class c is
                             pos[coff[c] .. coff[c+1]) ascending */
    const i64 *coff;      /* C+1 class offsets (also group-arena offsets) */
    const double *om_c, *md_c, *mc_c, *u_c;   /* class constants */
    const i64 *mn_c, *ms_c;
    Grp *ga;              /* group arena; class c's groups at coff[c].. */
    i64 *gcnt;            /* live group count per class */
    Grp *gsave;           /* iter_log: saved segments (same offsets) */
    i64 *scnt;
    u8 *touched;          /* iter_log membership */
    i64 *tlist, nt;
    i64 *u_p, *u_s, *u_n, nu;     /* undo: flat-mirror (p, old_s, old_n) */
    i64 *up_p;            /* balance updates: position */
    double *up_d;         /*                  delta    */
    u8 *bal_t;            /* classes touched by the current balance pass */
    i64 *bt_list;
    i64 *spe_l, *n_l;     /* flat per-layer design mirror */
    double res;
    i64 *mpos, *ms, *mn, mp, M;
} GCtx;

static double g_rate(const GCtx *g, i64 c, i64 s, i64 nn) {
    return rate_of(g->om_c[c], g->md_c[c], g->mc_c[c], s, nn);
}

static void g_setrates(const GCtx *g, i64 c, Grp *p) {
    p->r = g_rate(g, c, p->s, p->n);
    p->rnh = g_rate(g, c, p->s, p->n > 1 ? p->n / 2 : 1);
    p->rsh = g_rate(g, c, p->s > 1 ? p->s / 2 : 1, p->n);
}

static void g_touch(GCtx *g, i64 c) {
    if (!g->touched[c]) {
        g->touched[c] = 1;
        g->tlist[g->nt++] = c;
        g->scnt[c] = g->gcnt[c];
        memcpy(g->gsave + g->coff[c], g->ga + g->coff[c],
               (size_t)g->gcnt[c] * sizeof(Grp));
    }
}

static void g_compact(GCtx *g, i64 c) {
    Grp *seg = g->ga + g->coff[c];
    i64 nold = g->gcnt[c], j, out = 0;
    for (j = 1; j < nold; j++) {
        if (seg[out].s == seg[j].s && seg[out].n == seg[j].n) {
            seg[out].cnt += seg[j].cnt;
        } else {
            out++;
            if (out != j) seg[out] = seg[j];
        }
    }
    g->gcnt[c] = nold ? out + 1 : 0;
}

/* (min rate, argmin slot, strict second) in one pass; rate ties break by
   lowest member position — the flat engine's thr.index(min). */
static void g_scanmin(const GCtx *g, double *cur_out, i64 *bc_out,
                      i64 *bg_out, double *second_out) {
    double cur = INFINITY, second = INFINITY;
    i64 best_c = -1, best_g = -1, best_pos = g->L, c, gi;
    for (c = 0; c < g->C; c++) {
        const Grp *seg = g->ga + g->coff[c];
        for (gi = 0; gi < g->gcnt[c]; gi++) {
            double r = seg[gi].r;
            if (r < cur) {
                second = cur;
                cur = r;
                best_c = c;
                best_g = gi;
                best_pos = g->pos[g->coff[c] + seg[gi].start];
            } else if (r == cur) {
                second = cur;
                {
                    i64 p = g->pos[g->coff[c] + seg[gi].start];
                    if (p < best_pos) {
                        best_c = c;
                        best_g = gi;
                        best_pos = p;
                    }
                }
            } else if (r < second) {
                second = r;
            }
        }
    }
    *cur_out = cur;
    *bc_out = best_c;
    *bg_out = best_g;
    *second_out = second;
}

/* One Eq. 4-5 pass at fixed lo over all groups; skip one group (skip_c,
   skip_g) or a per-slot protected mask. Shrink chains are per-group; res
   deltas are then applied in ascending copy-position order — the flat
   engine's float summation, term for term (updates.sort() in Python).
   mc_row accumulates this row's mutation count. Returns 0 / -1 overflow. */
static int g_balance(GCtx *g, double lo, i64 skip_c, i64 skip_g,
                     const u8 *prot) {
    i64 c, gi, j, nupd = 0, nbt = 0;
    for (c = 0; c < g->C; c++) {
        Grp *seg = g->ga + g->coff[c];
        for (gi = 0; gi < g->gcnt[c]; gi++) {
            Grp *grp = seg + gi;
            i64 s = grp->s, nn = grp->n, s_i, n_i;
            double delta;
            if (prot ? prot[g->coff[c] + gi]
                     : (c == skip_c && gi == skip_g)) continue;
            if (!((nn > 1 && grp->rnh >= lo) || (s > 1 && grp->rsh >= lo)))
                continue;
            g_touch(g, c);
            s_i = s;
            n_i = nn;
            for (;;) {
                if (n_i > 1 && g_rate(g, c, s_i, n_i / 2) >= lo) {
                    n_i /= 2;
                    continue;
                }
                if (s_i > 1 && g_rate(g, c, s_i / 2, n_i) >= lo) {
                    s_i /= 2;
                    continue;
                }
                break;
            }
            delta = (double)(s_i * n_i - s * nn) * g->u_c[c];
            for (j = grp->start; j < grp->start + grp->cnt; j++) {
                i64 p = g->pos[g->coff[c] + j];
                g->up_p[nupd] = p;
                g->up_d[nupd] = delta;
                nupd++;
                g->u_p[g->nu] = p;
                g->u_s[g->nu] = g->spe_l[p];
                g->u_n[g->nu] = g->n_l[p];
                g->nu++;
                if (g->mp >= g->M) return -1;
                g->mpos[g->mp] = p;
                g->ms[g->mp] = s_i;
                g->mn[g->mp] = n_i;
                g->mp++;
                g->spe_l[p] = s_i;
                g->n_l[p] = n_i;
            }
            grp->s = s_i;
            grp->n = n_i;
            g_setrates(g, c, grp);
            if (!g->bal_t[c]) {
                g->bal_t[c] = 1;
                g->bt_list[nbt++] = c;
            }
        }
    }
    /* ascending-position application of the deltas (updates.sort()) */
    for (j = 1; j < nupd; j++) {          /* insertion sort by position */
        i64 kp = g->up_p[j], i2 = j - 1;
        double kd = g->up_d[j];
        while (i2 >= 0 && g->up_p[i2] > kp) {
            g->up_p[i2 + 1] = g->up_p[i2];
            g->up_d[i2 + 1] = g->up_d[i2];
            i2--;
        }
        g->up_p[i2 + 1] = kp;
        g->up_d[i2 + 1] = kd;
    }
    for (j = 0; j < nupd; j++) g->res += g->up_d[j];
    for (j = 0; j < nbt; j++) {
        g_compact(g, g->bt_list[j]);
        g->bal_t[g->bt_list[j]] = 0;
    }
    return 0;
}

static int run_grouped(GCtx *g, i64 max_iters, double budget,
                       double *res_out, double *fthr_out, double *theta_out,
                       double *trr, double *trc, i64 *tr_len,
                       i64 *mc, u8 *prot) {
    i64 c, gi, j, it = 0, row = 0, row_mp;
    double theta, hi, f_thr;
    int broke = 0;
    for (c = 0; c < g->C; c++) {          /* all groups at the (1,1) floor */
        Grp *grp = g->ga + g->coff[c];
        grp->start = 0;
        grp->cnt = g->coff[c + 1] - g->coff[c];
        grp->s = 1;
        grp->n = 1;
        g_setrates(g, c, grp);
        g->gcnt[c] = 1;
        g->touched[c] = 0;
        g->bal_t[c] = 0;
    }
    while (it < max_iters && !broke) {
        double cur_thr, second, cur_res, best_score, grown_rate, dgrow;
        double m_after, res_before;
        i64 slow_c, slow_gi, s, nn, b_s, b_n, wave, p_grown, start0;
        i64 grown_gi;
        Grp *slow_g, *grown;
        int have;
        g_scanmin(g, &cur_thr, &slow_c, &slow_gi, &second);
        slow_g = g->ga + g->coff[slow_c] + slow_gi;
        s = slow_g->s;
        nn = slow_g->n;
        cur_res = (double)(s * nn) * g->u_c[slow_c];
        have = 0;
        b_s = 0; b_n = 0; best_score = 0.0;
        if (nn < g->mn_c[slow_c]) {
            i64 n2 = nn * 2;
            double dres, sc;
            if (n2 > g->mn_c[slow_c]) n2 = g->mn_c[slow_c];
            dres = (double)(s * n2) * g->u_c[slow_c] - cur_res;
            if (dres < 1e-9) dres = 1e-9;
            sc = (g_rate(g, slow_c, s, n2) - cur_thr) / dres;
            have = 1; b_s = s; b_n = n2; best_score = sc;
        }
        if (s < g->ms_c[slow_c]) {
            i64 s2 = s * 2;
            double dres, sc;
            if (s2 > g->ms_c[slow_c]) s2 = g->ms_c[slow_c];
            dres = (double)(s2 * nn) * g->u_c[slow_c] - cur_res;
            if (dres < 1e-9) dres = 1e-9;
            sc = (g_rate(g, slow_c, s2, nn) - cur_thr) / dres;
            if (!have || sc > best_score) { have = 1; b_s = s2; b_n = nn; }
        }
        if (!have) {                      /* saturated: row stays, no muts */
            trr[row] = g->res;
            trc[row] = cur_thr;
            mc[row] = 0;
            row++;
            break;
        }
        grown_rate = g_rate(g, slow_c, b_s, b_n);
        dgrow = (double)(b_s * b_n - s * nn) * g->u_c[slow_c];
        /* wave width: identical lagging copies whose growth + no-op
           balance collapse into bookkeeping (see the Python engine) */
        wave = 0;
        if (slow_g->cnt > 1 && grown_rate > cur_thr && cur_thr < second) {
            double lo_w = cur_thr * (1 + 1e-9);
            double g_nh = g_rate(g, slow_c, b_s, b_n > 1 ? b_n / 2 : 1);
            double g_sh = g_rate(g, slow_c, b_s > 1 ? b_s / 2 : 1, b_n);
            if (!((b_n > 1 && g_nh >= lo_w) || (b_s > 1 && g_sh >= lo_w))) {
                wave = slow_g->cnt - 2;   /* last copy takes a real round */
                if (wave > max_iters - it - 1) wave = max_iters - it - 1;
            }
        }
        for (j = 0; j < g->nt; j++) g->touched[g->tlist[j]] = 0;
        g->nt = 0;                        /* iter_log.clear() */
        g->nu = 0;                        /* undo.clear() */
        res_before = g->res;
        g_touch(g, slow_c);
        trr[row] = g->res;
        trc[row] = cur_thr;
        row_mp = g->mp;
        /* split the first (lowest-position) copy off the argmin group and
           grow it — the flat engine grows exactly that layer index */
        if (slow_g->cnt == 1) {
            grown_gi = slow_gi;
        } else {
            Grp *seg = g->ga + g->coff[slow_c];
            memmove(seg + slow_gi + 1, seg + slow_gi,
                    (size_t)(g->gcnt[slow_c] - slow_gi) * sizeof(Grp));
            g->gcnt[slow_c]++;
            grown_gi = slow_gi;
            seg[grown_gi].cnt = 1;
            seg[grown_gi + 1].start += 1;
            seg[grown_gi + 1].cnt -= 1;
            slow_g = seg + grown_gi + 1;
        }
        grown = g->ga + g->coff[slow_c] + grown_gi;
        g->res += dgrow;
        grown->s = b_s;
        grown->n = b_n;
        g_setrates(g, slow_c, grown);
        start0 = grown->start;
        p_grown = g->pos[g->coff[slow_c] + start0];
        g->u_p[g->nu] = p_grown;
        g->u_s[g->nu] = g->spe_l[p_grown];
        g->u_n[g->nu] = g->n_l[p_grown];
        g->nu++;
        if (g->mp >= g->M) return 1;
        g->mpos[g->mp] = p_grown;
        g->ms[g->mp] = b_s;
        g->mn[g->mp] = b_n;
        g->mp++;
        g->spe_l[p_grown] = b_s;
        g->n_l[p_grown] = b_n;
        /* min(thr) after the growth, without a rescan (see Python) */
        if (grown_gi == slow_gi && grown == slow_g)
            m_after = second < grown_rate ? second : grown_rate;
        else
            m_after = cur_thr;
        if (g_balance(g, m_after * (1 + 1e-9), slow_c, grown_gi, 0) < 0)
            return 1;
        g_compact(g, slow_c);
        it++;
        if (g->res > budget) {            /* revert the whole iteration */
            for (j = 0; j < g->nt; j++) {
                c = g->tlist[j];
                g->gcnt[c] = g->scnt[c];
                memcpy(g->ga + g->coff[c], g->gsave + g->coff[c],
                       (size_t)g->scnt[c] * sizeof(Grp));
            }
            for (j = g->nu - 1; j >= 0; j--) {
                g->spe_l[g->u_p[j]] = g->u_s[j];
                g->n_l[g->u_p[j]] = g->u_n[j];
            }
            g->mp = row_mp;               /* muts[-1] = [] */
            mc[row] = 0;
            row++;
            g->res = res_before;
            break;
        }
        mc[row] = g->mp - row_mp;
        row++;
        if (!wave) continue;
        /* batched wave steps: compact() may have merged the grown
           singleton into an adjacent same-state accumulator group, so
           re-locate the LIVE groups holding the grown copy (acc) and the
           lagging remainder (always the next slot: states differ) */
        {
            Grp *seg = g->ga + g->coff[slow_c];
            Grp *acc = 0;
            i64 w;
            for (gi = 0; gi < g->gcnt[slow_c]; gi++)
                if (seg[gi].start <= start0 &&
                    start0 < seg[gi].start + seg[gi].cnt) {
                    acc = seg + gi;
                    break;
                }
            slow_g = acc + 1;
            for (w = 0; w < wave; w++) {
                double res_wave = g->res;
                i64 p = g->pos[g->coff[slow_c] + slow_g->start];
                trr[row] = g->res;
                trc[row] = cur_thr;
                row_mp = g->mp;
                slow_g->start++;
                slow_g->cnt--;
                acc->cnt++;
                g->res += dgrow;
                if (g->mp >= g->M) return 1;
                g->mpos[g->mp] = p;
                g->ms[g->mp] = b_s;
                g->mn[g->mp] = b_n;
                g->mp++;
                g->spe_l[p] = b_s;
                g->n_l[p] = b_n;
                it++;
                if (g->res > budget) {
                    slow_g->start--;
                    slow_g->cnt++;
                    acc->cnt--;
                    g->spe_l[p] = s;
                    g->n_l[p] = nn;
                    g->mp = row_mp;
                    mc[row] = 0;
                    row++;
                    g->res = res_wave;
                    broke = 1;
                    break;
                }
                mc[row] = 1;
                row++;
            }
        }
    }
    /* final literal Eq. 4 pass: trim, protect the bottleneck set */
    {
        double cur, second;
        i64 bc, bg;
        g_scanmin(g, &cur, &bc, &bg, &second);
        theta = cur;
    }
    hi = theta * (1 + 1e-9);
    for (c = 0; c < g->C; c++)
        for (gi = 0; gi < g->gcnt[c]; gi++)
            prot[g->coff[c] + gi] =
                (u8)(g->ga[g->coff[c] + gi].r <= hi);
    row_mp = g->mp;
    g->nu = 0;
    if (g_balance(g, theta * (1 - 1e-12), -1, -1, prot) < 0) return 1;
    mc[row] = g->mp - row_mp;
    {
        double cur, second;
        i64 bc, bg;
        g_scanmin(g, &cur, &bc, &bg, &second);
        f_thr = cur;
    }
    *res_out = g->res;
    *fthr_out = f_thr;
    *theta_out = theta;
    *tr_len = row;
    return 0;
}

/* ------------------------------------------------------------------ */
/* Batch loop:   per proposal, build dynamics classes and dispatch     */
/* grouped/flat by the serial auto rule; identical outputs either way. */
/* ------------------------------------------------------------------ */

int dse_run_batch(i64 B, i64 L, i64 max_iters, double budget,
                  const double *omsm, const double *s_eff,
                  const double *m_dot, const double *macs,
                  const double *unit,
                  const i64 *max_n, const i64 *max_spe,
                  i64 *spe_out, i64 *n_out,
                  double *res_out, double *fthr_out, double *theta_out,
                  double *tr_res, double *tr_cur, i64 *tr_len,
                  i64 *mut_pos, i64 *mut_s, i64 *mut_n, i64 *mut_cnt,
                  i64 M) {
    i64 b, i, c;
    int rc = 0;
    /* one workspace arena for everything per-proposal */
    size_t sz_i = (size_t)(L + (L + 1) + L + 2 * L      /* cls,coff,pos,mn/ms_c */
                           + 2 * L                      /* gcnt,scnt */
                           + 2 * L                      /* tlist,bt_list */
                           + 3 * (2 * L + 4)            /* undo */
                           + L                          /* up_p */
                           + 3 * L) * sizeof(i64);      /* ch_i/s/n */
    size_t sz_d = (size_t)(4 * L                        /* om/md/mc/u_c */
                           + L                          /* up_d */
                           + 3 * L) * sizeof(double);   /* thr,r_nh,r_sh */
    size_t sz_g = 2 * (size_t)L * sizeof(Grp);          /* ga, gsave */
    size_t sz_b = 3 * (size_t)L + 8;                    /* touched,bal_t,prot */
    char *ws = (char *)malloc(sz_i + sz_d + sz_g + sz_b);
    i64 *cls, *coff, *pos, *mn_c, *ms_c, *gcnt, *scnt, *tlist, *bt_list;
    i64 *u_p, *u_s, *u_n, *up_p, *ch_i, *ch_s, *ch_n;
    double *om_c, *md_c, *mc_c, *u_c, *up_d, *thr, *r_nh, *r_sh;
    Grp *ga, *gsave;
    u8 *touched, *bal_t, *prot;
    if (!ws) return 2;
    {
        char *q = ws;
        cls = (i64 *)q; q += L * sizeof(i64);
        coff = (i64 *)q; q += (L + 1) * sizeof(i64);
        pos = (i64 *)q; q += L * sizeof(i64);
        mn_c = (i64 *)q; q += L * sizeof(i64);
        ms_c = (i64 *)q; q += L * sizeof(i64);
        gcnt = (i64 *)q; q += L * sizeof(i64);
        scnt = (i64 *)q; q += L * sizeof(i64);
        tlist = (i64 *)q; q += L * sizeof(i64);
        bt_list = (i64 *)q; q += L * sizeof(i64);
        u_p = (i64 *)q; q += (2 * L + 4) * sizeof(i64);
        u_s = (i64 *)q; q += (2 * L + 4) * sizeof(i64);
        u_n = (i64 *)q; q += (2 * L + 4) * sizeof(i64);
        up_p = (i64 *)q; q += L * sizeof(i64);
        ch_i = (i64 *)q; q += L * sizeof(i64);
        ch_s = (i64 *)q; q += L * sizeof(i64);
        ch_n = (i64 *)q; q += L * sizeof(i64);
        om_c = (double *)q; q += L * sizeof(double);
        md_c = (double *)q; q += L * sizeof(double);
        mc_c = (double *)q; q += L * sizeof(double);
        u_c = (double *)q; q += L * sizeof(double);
        up_d = (double *)q; q += L * sizeof(double);
        thr = (double *)q; q += L * sizeof(double);
        r_nh = (double *)q; q += L * sizeof(double);
        r_sh = (double *)q; q += L * sizeof(double);
        ga = (Grp *)q; q += L * sizeof(Grp);
        gsave = (Grp *)q; q += L * sizeof(Grp);
        touched = (u8 *)q; q += L;
        bal_t = (u8 *)q; q += L;
        prot = (u8 *)q;
    }
    for (b = 0; b < B && rc == 0; b++) {
        const double *om = omsm + b * L;
        const double *se = s_eff + b * L;
        i64 C = 0;
        i64 *rep = scnt;                /* borrow: free until run_grouped */
        i64 *cnt = gcnt;
        /* dynamics classes: first-appearance order, key equality on the
           six per-layer constants (== compares; the Python dict key) */
        for (i = 0; i < L; i++) {
            for (c = 0; c < C; c++) {
                i64 r = rep[c];
                if (macs[i] == macs[r] && m_dot[i] == m_dot[r] &&
                    se[i] == se[r] && max_n[i] == max_n[r] &&
                    max_spe[i] == max_spe[r] && unit[i] == unit[r])
                    break;
            }
            cls[i] = c;
            if (c == C) {
                rep[c] = i;
                cnt[c] = 0;
                C++;
            }
            cnt[c]++;
        }
        {
            i64 acc = 0;
            for (c = 0; c < C; c++) {   /* counts -> offsets */
                coff[c] = acc;
                acc += cnt[c];
            }
            coff[C] = acc;
        }
        {
            i64 *fill = tlist;          /* borrow as per-class cursor */
            for (c = 0; c < C; c++) fill[c] = coff[c];
            for (i = 0; i < L; i++) pos[fill[cls[i]]++] = i;
        }
        for (c = 0; c < C; c++) {
            i64 r = rep[c];
            om_c[c] = om[r];
            md_c[c] = m_dot[r];
            mc_c[c] = macs[r];
            u_c[c] = unit[r];
            mn_c[c] = max_n[r];
            ms_c[c] = max_spe[r];
        }
        if (L >= 16 && 2 * C <= L) {    /* the serial auto dispatch rule */
            GCtx g;
            double res0 = 0.0;
            g.L = L;
            g.C = C;
            g.pos = pos;
            g.coff = coff;
            g.om_c = om_c;
            g.md_c = md_c;
            g.mc_c = mc_c;
            g.u_c = u_c;
            g.mn_c = mn_c;
            g.ms_c = ms_c;
            g.ga = ga;
            g.gcnt = gcnt;
            g.gsave = gsave;
            g.scnt = scnt;
            g.touched = touched;
            g.tlist = tlist;
            g.nt = 0;
            g.u_p = u_p;
            g.u_s = u_s;
            g.u_n = u_n;
            g.nu = 0;
            g.up_p = up_p;
            g.up_d = up_d;
            g.bal_t = bal_t;
            g.bt_list = bt_list;
            g.spe_l = spe_out + b * L;
            g.n_l = n_out + b * L;
            for (i = 0; i < L; i++) {
                g.spe_l[i] = 1;
                g.n_l[i] = 1;
                res0 += unit[i];        /* float(sum(unit)), same order */
            }
            g.res = res0;
            g.mpos = mut_pos + b * M;
            g.ms = mut_s + b * M;
            g.mn = mut_n + b * M;
            g.mp = 0;
            g.M = M;
            rc = run_grouped(&g, max_iters, budget,
                             res_out + b, fthr_out + b, theta_out + b,
                             tr_res + b * max_iters, tr_cur + b * max_iters,
                             tr_len + b, mut_cnt + b * (max_iters + 1),
                             prot);
        } else {
            rc = run_flat(L, max_iters, budget, om, m_dot, macs, unit,
                          max_n, max_spe, spe_out + b * L, n_out + b * L,
                          res_out + b, fthr_out + b, theta_out + b,
                          tr_res + b * max_iters, tr_cur + b * max_iters,
                          tr_len + b,
                          mut_pos + b * M, mut_s + b * M, mut_n + b * M,
                          mut_cnt + b * (max_iters + 1), M,
                          thr, r_nh, r_sh, ch_i, ch_s, ch_n, prot);
        }
    }
    free(ws);
    return rc;
}

/* Replay one proposal's mutation log, materializing the kept frontier
   rows: row j < n_rows-1 is the state BEFORE muts[j] (trace rows record
   state at iteration start); the last row is the state AFTER the final
   Eq. 4 pass. keep_rows must be ascending; snapshots land in keep order. */
void dse_replay(i64 L, i64 n_rows,
                const i64 *mut_pos, const i64 *mut_s, const i64 *mut_n,
                const i64 *mut_cnt,
                i64 n_keep, const i64 *keep_rows,
                i64 *out_spe, i64 *out_n, i64 *w_spe, i64 *w_n) {
    i64 i, j, t, off = 0, k = 0;
    for (i = 0; i < L; i++) { w_spe[i] = 1; w_n[i] = 1; }
    for (j = 0; j < n_rows; j++) {
        i64 c = mut_cnt[j];
        if (j < n_rows - 1) {
            if (k < n_keep && keep_rows[k] == j) {
                memcpy(out_spe + k * L, w_spe, (size_t)L * sizeof(i64));
                memcpy(out_n + k * L, w_n, (size_t)L * sizeof(i64));
                k++;
            }
            for (t = 0; t < c; t++) {
                w_spe[mut_pos[off + t]] = mut_s[off + t];
                w_n[mut_pos[off + t]] = mut_n[off + t];
            }
        } else {
            for (t = 0; t < c; t++) {
                w_spe[mut_pos[off + t]] = mut_s[off + t];
                w_n[mut_pos[off + t]] = mut_n[off + t];
            }
            if (k < n_keep && keep_rows[k] == j) {
                memcpy(out_spe + k * L, w_spe, (size_t)L * sizeof(i64));
                memcpy(out_n + k * L, w_n, (size_t)L * sizeof(i64));
                k++;
            }
        }
        off += c;
    }
}
"""

# -ffp-contract=off is load-bearing: GCC contracts a*b-c into FMA by
# default, which rounds once where numpy rounds twice. No -ffast-math.
_CFLAGS = ["-O2", "-fPIC", "-shared", "-std=c99", "-ffp-contract=off"]

# raw pointers, not np.ctypeslib.ndpointer: ndpointer's from_param runs
# dtype/flag checks per argument per call (~0.3ms/wave of pure overhead on
# the hot path). The ONLY call sites are ``dse._run_incremental_batch_c``,
# which allocates every array itself with the right dtype and C order —
# pass ``arr.ctypes.data``.
_i64p = ctypes.c_void_p
_f64p = ctypes.c_void_p

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_dir() -> str:
    return os.environ.get("REPRO_CKERNEL_DIR") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_build")


def _compiler() -> Optional[str]:
    for cand in ("cc", "gcc", "clang"):
        path = shutil.which(cand)
        if path:
            return path
    return None


def compile_shared(stem: str, src: str, cflags) -> Optional[ctypes.CDLL]:
    """Load ``src`` compiled with ``cflags`` as a shared object, building
    it into ``_build_dir()`` as ``<stem>_<hash>.so`` if no build of this
    source and these flags is there yet. None without a compiler or when
    the build or the load fails."""
    tag = hashlib.sha256(
        (src + "\x00" + " ".join(cflags)).encode()).hexdigest()[:16]
    bdir = _build_dir()
    so = os.path.join(bdir, f"{stem}_{tag}.so")
    if not os.path.exists(so):
        cc = _compiler()
        if cc is None:
            return None
        try:
            os.makedirs(bdir, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=bdir) as td:
                c_path = os.path.join(td, f"{stem}.c")
                tmp_so = os.path.join(td, f"{stem}.so")
                with open(c_path, "w") as f:
                    f.write(src)
                subprocess.run([cc, *cflags, c_path, "-o", tmp_so, "-lm"],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp_so, so)   # atomic publish; races converge
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        return ctypes.CDLL(so)
    except OSError:
        return None


def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("REPRO_DSE_CKERNEL", "1") in ("0", "off", "false"):
        return None
    lib = compile_shared("dse_kernel", _C_SRC, _CFLAGS)
    if lib is None:
        return None
    lib.dse_run_batch.restype = ctypes.c_int
    lib.dse_run_batch.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_double,
        _f64p, _f64p, _f64p, _f64p, _f64p, _i64p, _i64p,
        _i64p, _i64p, _f64p, _f64p, _f64p,
        _f64p, _f64p, _i64p,
        _i64p, _i64p, _i64p, _i64p, ctypes.c_longlong]
    lib.dse_replay.restype = None
    lib.dse_replay.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong,
        _i64p, _i64p, _i64p, _i64p,
        ctypes.c_longlong, _i64p, _i64p, _i64p, _i64p, _i64p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled kernel, built/loaded on first call; None when the
    environment can't provide it (no compiler, failed build, or disabled
    via ``REPRO_DSE_CKERNEL=0``) — callers fall back to numpy."""
    global _lib, _tried
    if not _tried:
        _tried = True
        _lib = _load()
    return _lib


def reset() -> None:
    """Forget the cached load attempt (tests toggle the env kill switch)."""
    global _lib, _tried
    _lib = None
    _tried = False

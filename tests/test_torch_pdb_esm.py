"""PDB and ESM2 inputs: the port against the JAX package.

- parse_pdb: equal to the JAX reader (sequence, backbone and all-atom
  coordinates, atom records, chain ids) on PDBs written from the 1QA9 and
  7CEI npz and on a hand-made PDB with altlocs, insertion codes, a residue
  missing its C, a HETATM and an unknown residue;
- the dock's --pdb job: its batch equals the --npz job's, the coordinates
  within 5e-4 A (the PDB format's 3 decimals);
- ESM2 at a small config (2 layers x 64 hidden x 4 heads): tokenize equal,
  the forward within rel 1e-5 of JAX's (padding and a <mask> token),
  convert_hf_esm of a HuggingFace-named state dict equal to JAX's;
- the providers raise the JAX package's error when the weights are absent.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfmdock_tpu.data import esm as jax_esm
from dfmdock_tpu.data.pdb_io import parse_pdb as jax_parse_pdb
from dfmdock_tpu.models import esm2 as jax_esm2
from dfmdock_tpu_torch.cli import dock
from dfmdock_tpu_torch.data import esm
from dfmdock_tpu_torch.data.convert import load_npz_complex
from dfmdock_tpu_torch.data.dataset import complex_to_batch
from dfmdock_tpu_torch.data.pdb_io import get_full_coords, parse_pdb, save_pdb
from dfmdock_tpu_torch.models import esm2
from _torch_parity import jax_flat
from dfmdock_tpu_torch.params import to_state_dict

ESM_REL = 1e-5  # float32 on both sides, the same operations
PDB_TOL = 5e-4  # Angstrom: a PDB holds 3 decimals
SMALL = dict(vocab_size=33, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, token_dropout=True)

HAND_MADE = """\
HEADER    HAND-MADE TEST
ATOM      1  N   ALA A   1      11.104   6.134  -6.504  1.00  0.00           N
ATOM      2  CA AALA A   1      11.639   6.071  -5.147  0.50  0.00           C
ATOM      3  CA BALA A   1      12.639   7.071  -4.147  0.50  0.00           C
ATOM      4  C   ALA A   1      13.149   5.858  -5.149  1.00  0.00           C
ATOM      5  CB  ALA A   1      11.300   7.350  -4.390  1.00  0.00           C
ATOM      6  N   GLY A   2      13.753   6.201  -4.014  1.00  0.00           N
ATOM      7  CA  GLY A   2      15.195   6.058  -3.857  1.00  0.00           C
ATOM      8  C   GLY A   2      15.603   4.595  -3.753  1.00  0.00           C
ATOM      9  N   GLY A   2A     16.101   4.175  -2.595  1.00  0.00           N
ATOM     10  CA  GLY A   2A     16.517   2.788  -2.380  1.00  0.00           C
ATOM     11  C   GLY A   2A     18.016   2.654  -2.590  1.00  0.00           C
ATOM     12  N   SER A   3      18.499   1.440  -2.859  1.00  0.00           N
ATOM     13  CA  SER A   3      19.920   1.205  -3.081  1.00  0.00           C
ATOM     14  OG  SER A   3      20.100   0.900  -1.700  1.00  0.00           O
HETATM   15  O   HOH A 101      21.000   2.000   3.000  1.00  0.00           O
ATOM     16  N   MSE B   1       1.000   2.000   3.000  1.00  0.00           N
ATOM     17  CA  MSE B   1       2.000   2.500   3.500  1.00  0.00           C
ATOM     18  C   MSE B   1       3.000   2.000   4.000  1.00  0.00           C
ATOM     19  N   LYS B   2       4.000   2.000   4.500  1.00  0.00           N
ATOM     20  CA  LYS B   2       5.000   2.500   5.000  1.00  0.00           C
ATOM     21  C   LYS B   2       6.000   2.000   5.500  1.00  0.00           C
ATOM     22  NZ  LYS B   2       7.000   3.000   6.000  1.00  0.00           N
END
"""


def assert_same_pdb(port, ref):
    assert port.seq == ref.seq
    assert port.chain_ids == ref.chain_ids
    assert port.atom_lines == ref.atom_lines
    np.testing.assert_array_equal(port.bb_coords, ref.bb_coords)
    np.testing.assert_array_equal(port.aa_coords, ref.aa_coords)


@pytest.mark.parametrize("cid", ["1QA9", "7CEI"])
def test_parse_pdb_matches_jax_on_written_complexes(tmp_path, cid):
    raw = load_npz_complex(f"data/db5_npz/{cid}.npz")
    coords = np.concatenate([raw["rec_pos"], raw["lig_pos"]])
    path = str(tmp_path / f"{cid}.pdb")
    save_pdb(path, get_full_coords(coords), raw["rec_seq"] + raw["lig_seq"],
             delim=len(raw["rec_seq"]) - 1)
    for chains in (None, ["A"], ["B"]):
        assert_same_pdb(parse_pdb(path, chains), jax_parse_pdb(path, chains))
    got = parse_pdb(path)
    assert got.seq == raw["rec_seq"] + raw["lig_seq"]
    assert np.abs(got.bb_coords - coords).max() <= PDB_TOL


def test_parse_pdb_matches_jax_on_hand_made_records(tmp_path):
    path = tmp_path / "hand.pdb"
    path.write_text(HAND_MADE)
    got, ref = parse_pdb(str(path)), jax_parse_pdb(str(path))
    assert_same_pdb(got, ref)
    # altloc A wins, 2A is its own residue, SER (no C) and the HETATM are
    # dropped, MSE is unknown -> X
    assert got.seq == "AGGXK"
    assert got.bb_coords[0, 1].tolist() == pytest.approx([11.639, 6.071, -5.147])
    assert got.chain_ids == ["A", "A", "A", "B", "B"]


def test_pdb_job_batch_matches_npz_job(tmp_path):
    raw = load_npz_complex("data/db5_npz/1QA9.npz")
    rec, lig = str(tmp_path / "rec.pdb"), str(tmp_path / "lig.pdb")
    save_pdb(rec, raw["rec_pos"], raw["rec_seq"])
    save_pdb(lig, raw["lig_pos"], raw["lig_seq"])
    args = argparse.Namespace(npz=None, pdb=[rec, lig], csv=None, one_hot_only=True,
                              esm_backend="auto")
    (job,) = dock.load_inputs(args, torch.device("cpu"))
    b_pdb, b_npz = complex_to_batch(job), complex_to_batch(raw)
    assert set(b_pdb) == set(b_npz)
    np.testing.assert_allclose(b_pdb["pos"], b_npz["pos"], rtol=0, atol=PDB_TOL)
    for k in ("node_mask", "lig_mask", "res_id", "asym_id", "n_rec", "n_lig"):
        np.testing.assert_array_equal(b_pdb[k], b_npz[k])
    np.testing.assert_array_equal(b_pdb["x"][:, esm.ESM_DIM:], b_npz["x"][:, esm.ESM_DIM:])
    assert not b_pdb["x"][:, : esm.ESM_DIM].any()  # --one-hot-only: zero ESM columns


@pytest.fixture(scope="module")
def hf_state():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.EsmModel(transformers.EsmConfig(
        vocab_size=33, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, position_embedding_type="rotary", layer_norm_eps=1e-5,
        token_dropout=True, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        pad_token_id=1, mask_token_id=esm2.MASK_ID, emb_layer_norm_before=False,
        max_position_embeddings=128), add_pooling_layer=False).eval()
    return hf, {k: v.numpy() for k, v in hf.state_dict().items()}


def test_tokenize_matches_jax():
    for seq, pad in (("MKVLAAG", None), ("MKVXBUZO", 16), ("ACDEFGHIKLMNPQRSTVWY", 30)):
        np.testing.assert_array_equal(esm2.tokenize(seq, pad), jax_esm2.tokenize(seq, pad))
    assert esm2.ESM_TOKENS == jax_esm2.ESM_TOKENS


def test_convert_hf_esm_matches_jax(hf_state):
    _, sd = hf_state
    got = esm2.convert_hf_esm(sd, esm2.ESM2Config(**SMALL))
    want = to_state_dict(jax_flat(jax_esm2.convert_hf_esm(sd, jax_esm2.ESM2Config(**SMALL))))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    model = esm2.ESM2(esm2.ESM2Config(**SMALL))
    model.load_state_dict(got)  # every key of the module, no other


@pytest.mark.parametrize("case", ["plain", "padded", "masked"])
def test_esm2_apply_matches_jax(hf_state, case):
    hf, sd = hf_state
    cfg = esm2.ESM2Config(**SMALL)
    model = esm2.ESM2(cfg)
    model.load_state_dict(esm2.convert_hf_esm(sd, cfg))
    params = jax.tree_util.tree_map(
        jnp.asarray, jax_esm2.convert_hf_esm(sd, jax_esm2.ESM2Config(**SMALL)))
    seq = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"
    tokens = esm2.tokenize(seq, pad_to=48 if case == "padded" else None)
    if case == "masked":
        tokens[[3, 9]] = esm2.MASK_ID
    with torch.no_grad():
        got = esm2.esm2_apply(model, tokens).numpy()
    want = np.asarray(jax_esm2.esm2_apply(params, jnp.asarray(tokens),
                                          jax_esm2.ESM2Config(**SMALL)))
    err = np.abs(got - want).max()
    assert err <= ESM_REL * np.abs(want).max(), err
    if case != "padded":  # and HuggingFace's EsmModel itself, as the JAX tests hold it
        with torch.no_grad():
            hf_out = hf(input_ids=torch.from_numpy(tokens[None].astype(np.int64))
                        ).last_hidden_state[0].numpy()
        np.testing.assert_allclose(got, hf_out, rtol=2e-3, atol=2e-4)
    if case == "plain":
        np.testing.assert_array_equal(esm2.embed_sequence(model, seq).numpy(),
                                      got[1 : len(seq) + 1])


def test_provider_raises_jax_message_without_weights(tmp_path):
    name = "facebook/esm2_t33_650M_UR50D"
    with pytest.raises(RuntimeError) as want:
        jax_esm.ESMProvider(model_name=name)._load()
    with pytest.raises(RuntimeError) as got_hf:
        esm.HFESMProvider(model_name=name).embed("MKV")
    with pytest.raises(RuntimeError) as got_torch:
        esm.get_provider("torch")
    assert str(got_hf.value) == str(want.value)
    assert str(got_torch.value).startswith("ESM2 weights unavailable locally")
    assert str(got_torch.value).endswith(str(want.value).split(").", 1)[1])
    assert not esm.embeddings_available()
    pdb = tmp_path / "hand.pdb"
    pdb.write_text(HAND_MADE)
    with pytest.raises(RuntimeError, match="--one-hot-only"):
        dock.main(["--pdb", str(pdb), str(pdb), "--device", "cpu", "--esm-backend", "hf",
                   "--out-dir", str(tmp_path)])

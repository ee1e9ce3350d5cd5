"""MNT6753 and Coda's Bowe-Gabizon verifier in plain Python integers: the
benchmark's reference for a configuration whose "curve" is "mnt6753".  It
follows src/mnt6753.js's verifySync (:614-726) and imports nothing of the
program under test; the curve's constants, the Pedersen hash's 12 bases
among them, are copied here as data.

    curve() -> Mnt6753
    Mnt6753.pairing_eq([(P, Q), ...], expected) -> prod e(P_i, Q_i) == expected
    Mnt6753.ys_many([(A, B, C, dp), ...]) -> Ys of each: the group map of
        blake2s of the Pedersen hash of the points' bits
    verify_bg(cv, vk, inputs, proof) -> both equations by the pairing
    verify_exponent(cv, td, values, logs, points) -> both equations from the
        trapdoor that made the key and the proof
    blake2s(data) -> the 32-byte BLAKE2s digest (RFC 7693), written out here

Fields: F3 = Fp[v]/(v^3 - 11), F6 = F3[w]/(w^2 - v).  G1: y^2 = x^3 + 11 x
+ b over Fp; G2: y^2 = x^3 + 11 v^2 x + 11 b over F3, untwisted onto
E(F6) by (x, y) -> (x w^-2, y w^-3).  The ate pairing: the textbook affine
Miller loop over the 377-bit loop count (positive, no correction steps),
then f^((q^3 - 1)(q + 1)(q + w0)) with w0 the loop count.  Points are
affine (x, y) tuples, None for zero, outside the Jacobian group law."""

from __future__ import annotations

import dataclasses
import functools

from .curves import FixedBase, Jacobian
from .fields import F2, F3, Fp

Q = 41898490967918953402344214791240637128170709919953949071783502921025352812571106773058893763790338921418070971888458477323173057491593855069696241854796396165721416325350064441470418137846398469611935719059908164220784476160001
R = 41898490967918953402344214791240637128170709919953949071783502921025352812571106773058893763790338921418070971888253786114353726529584385201591605722013126468931404347949840543007986327743462853720628051692141265303114721689601

A = 11          # G1 coefficient a; G2 a2 = 11 v^2; F3 non-residue 11
B = 11625908999541321152027340224010374716841167701783584648338908235410859267060079819722747939267925389062611062156601938166010098747920378738927832658133625454260115409075816187555055859490253375704728027944315501122723426879114
NR = 11

ATE_LOOP_COUNT = 204691208819330962009469868104636132783269696790011977400223898462431810102935615891307667367766898917669754470400

G1_GEN = (16364236387491689444759057944334173579070747473738339749093487337644739228935268157504218078126401066954815152892688541654726829424326599038522503517302466226143788988217410842672857564665527806044250003808514184274233938437290,
          4510127914410645922431074687553594593336087066778984214797709122300210966076979927285161950203037801392624582544098750667549188549761032654706830225743998064330900301346566408501390638273322467173741629353517809979540986561128)

G2_GEN = (
    (46538297238006280434045879335349383221210789488441126073640895239023832290080310125413049878152095926176013036314720850781686614265244307536450228450615346834324267478485994670716807428718518299710702671895190475661871557310,
     10329739935427016564561842963551883445915701424214177782911128765230271790215029185795830999583638744119368571742929964793955375930677178544873424392910884024986348059137449389533744851691082159233065444766899262771358355816328,
     19962817058174334691864015232062671736353756221485896034072814261894530786568591431279230352444205682361463997175937973249929732063490256813101714586199642571344378012210374327764059557816647980334733538226843692316285591005879),
    (5648166377754359996653513138027891970842739892107427747585228022871109585680076240624013411622970109911154113378703562803827053335040877618934773712021441101121297691389632155906182656254145368668854360318258860716497525179898,
     26817850356025045630477313828875808893994935265863280918207940412617168254772789578700316551065949899971937475487458539503514034928974530432009759562975983077355912050606509147904958229398389093697494174311832813615564256810453,
     32332319709358578441696731586704495581796858962594701633932927358040566210788542624963749336109940335257143899293177116050031684054348958813290781394131284657165540476824211295508498842102093219808642563477603392470909217611033),
)

GROUP_MAP_CONIC_C = 10474622741979738350586053697810159282042677479988487267945875730256338203142776693264723440947584730354517742972114619330793264372898463767424060463699099041430354081337516110367604534461599617402983929764977041055196119040012
GROUP_MAP_PROJ_Z = 38365735639699746381939366704915555468563774296792699496721397906733830428037078183799997086205833647489050605889539959322880863358082391473031143521765387671570958090617625358358885062894615919620647426481572278916894388596945

PEDERSEN_CHUNK_SIZE = 188
PEDERSEN_BASES = [
    (2071893303198007985737678972190309212568452221625132024511988170095494148670997278812694070338313361389889122280160253462982652030041813566301365289695187505618174204273471887226695702458395861269694368663558765191107385382142,
     17187187414417664367585796530257262302159176591062800465884265459977066325098901507827719965058588341044788483232395252403515861767227243983849894797683644816538861625368393588001624014759720661490214325432345769098675755344007),
    (12212700530208157134689256057121042620633735483309261868159828729358269133353025097021648766749096328904625282610227267815597560656189994727627613599055093979638719153187781645363642530065802177696707603573183038198049837281284,
     25783690089010390455572974279288664362239817189553105020262800542618336981545722940934884637537924384027963108482794866752096889610121505188228870561534980224779056104062778099246844511975082198175449341056361726557212816273203),
    (24970556048065806436025775756019294569514287852390684813064321958272933228137795169157911036418821145649315804385644486444483724251269635399290126638401987231852781394516304251109918520031098349546899855265794613791318815401876,
     31962426837049224740980485154381998358868991216693595616538747324158910634872015696123705432006307054685021215563881823301198025102710386453970240354239402398745821628720107919855566997584156778139135499881940592882629489943551),
    (4431264411717549274439490659582560401278429696218324463252012866668010436230467390709079687847260266333949609702709398614735778908621392906775244210809408019439483728382538000678063011124654256466867465806472450156285959296478,
     5357104929738581133630585435713154584790058687516758823722160588386982989576958329026493218285464648215758171648009368623425257221760769388865621253647844864279048734223948216626860899712215839882580351969504555475483295828321),
    (6671433602972561813695090966408317709238420789110797829702834855105065892311048504872981038933746208133427345903147737968972400166128764694941204592973429712710593028851732935226387767696882706160253984317874861465334699161990,
     21711555364470068355814107901005676801426239531219087510381972880175131973242407029290710493957974865954350244915332826635503654142837214217367474143450949577779528038476129095441904192715126325925180200706764720129647900154510),
    (3279287280516667726034641228088153493377068947932964914992332109534304163378313362642088339811737854700479601646880961405137089274374094406319964129318466368217040667072259586616947873396338805588189680637610631077799406849678,
     36083410532375699766897530133147718931585816209038495573380944607379201487163666226805598827634658263382384531791578426004569849840500849793075159834066479383773342040065664681946311465722831163353980052849824208445357276512039),
    (6080315379067559396366920603391445316068884876999059159889161166465434118824372554207399274504146495157531657398487486565476348416859948241407968265138831613853730297645692192334843976583486101896736840413872097839964499683332,
     26420424881408892228870218588074681761407815765852299070750308032078795079763335114222685666340147826454447640325063954005645285100365609355311780905109783862569185820306941334828547063301806152701392010289886220468661953965919),
    (39301831400422949389818222554551556278076967824511010861535510094278551646323817962504510429949535607847124719220397592919414191667356795652722963307663320704947997484288198213588564623546419124090570040138115255574753268044296,
     36457812814376230890682190373753614518702525324272794059443925877471853974877472140825740785996758245920724784158181335975363784020543877031746359325492875482739908200696955809723414504629601464266420637086159099075048645416374),
    (7540664997550190973602360351030883142324749771399862809105176292300299526593722518355361727448429173635571954137685816627918496116227546648451982643232613412226512084475776533244886987139627138835739493051117039845249333293796,
     41832168374796125531735699856185177965741887376998317172586340222379811256102274861246907652644659486244227261842256173112551393210515106271575307252302330588981902151799763241646966710905966859708456096352215232407040721812440),
    (36397483455279521486180767892445054628947434149047678403043888842127539677645442740735471632069262625023630925482329096023950321390546066181899597320416634680062586092646310952310844092327312810134226425393239318043723435147242,
     18286472905180979924646715322917829676123207845562357760879307637733164075896656550520464980631401874233327857749869297454439627725894967171722892001304897028600380951109713197296853450963512190698451016172641099337226932835103),
    (38971740405150801303656120540964048311055428317597420804659853006910052152298169876746036294761470660390748610246706280407819428237389693394271333553585474382213782764591195401917422695201611402679319607462045083981820266292526,
     12052300622245628070333354588755219239307478469529845235720526151711813563444656737524423919201679934065964579148677093493832843694922101898382470265577630638871822779691658559083989998504649770048646951871151837463810472588643),
    (28580639909521896467730379621107007981713563598576419274286032656030060646413984885651670728423715399952200046109842062405825188571385283021073346904536651485834210457583868625103914909503900539953858010694440026958408821693616,
     33074070963001755009804136607611008375296623364907104158069380168975081449307467755506733151497347867221785696657950398557975950305507047259982036542250828282873739093067701764175433149313198906930824052021363292166457216217373),
]

# the verifier hashes A, B, C and dp: a G1 point as the low bit of y and
# the 753 bits of x, a G2 point as the low bit of y's first coordinate and
# x's three coordinates' 753 bits each (mnt6753.js:645-658)
FQ_BITS = 753
VERIFIER_BITS = 2 * (1 + FQ_BITS) + 2 * (1 + 3 * FQ_BITS)


def _batch_inv(xs, q: int) -> list:
    """The inverses of nonzero xs mod q through one inversion."""
    prefix, acc = [], 1
    for x in xs:
        prefix.append(acc)
        acc = acc * x % q
    inv = pow(acc, -1, q)
    out = [0] * len(xs)
    for k in range(len(xs) - 1, -1, -1):
        out[k] = prefix[k] * inv % q
        inv = inv * xs[k] % q
    return out


def add_affine_many(pairs, q: int, a: int) -> list:
    """P + Q for each (P, Q) of affine points over Fp (None: zero) on
    y^2 = x^3 + a x + b, the slopes' denominators inverted together."""
    kinds, dens = [], []
    for P, Q in pairs:
        if P is None or Q is None:
            kinds.append(0)
        elif P[0] != Q[0]:
            kinds.append(1)
            dens.append((Q[0] - P[0]) % q)
        elif P[1] and P[1] == Q[1]:
            kinds.append(2)
            dens.append(2 * P[1] % q)
        else:                           # P = -Q
            kinds.append(3)
    invs = iter(_batch_inv(dens, q))
    out = []
    for (P, Q), k in zip(pairs, kinds):
        if k == 0:
            out.append(Q if P is None else P)
            continue
        if k == 3:
            out.append(None)
            continue
        x1, y1 = P
        num = Q[1] - y1 if k == 1 else 3 * x1 * x1 + a
        lam = num * next(invs) % q
        x3 = (lam * lam - x1 - Q[0]) % q
        out.append((x3, (lam * (x1 - x3) - y1) % q))
    return out


def sum_affine_many(rows, q: int, a: int) -> list:
    """The sum of each row of affine points, by a tree whose every level
    adds the pairs of all rows at once."""
    rows = [list(r) for r in rows]
    while any(len(r) > 1 for r in rows):
        pairs, at = [], []
        for i, r in enumerate(rows):
            for k in range(0, len(r) - 1, 2):
                pairs.append((r[k], r[k + 1]))
                at.append(i)
        sums = iter(add_affine_many(pairs, q, a))
        new = [[] for _ in rows]
        for i in at:
            new[i].append(next(sums))
        for i, r in enumerate(rows):
            if len(r) % 2:
                new[i].append(r[-1])
        rows = new
    return [r[0] if r else None for r in rows]


class JacobianA(Jacobian):
    """y^2 = x^3 + a x + b in Jacobian coordinates: the add of curves.py
    (which does not depend on a) and the doubling dbl-2007-bl."""

    def __init__(self, F, a):
        super().__init__(F)
        self.a = a

    def double(self, p):
        F = self.F
        if self.is_zero(p):
            return p
        X, Y, Z = p
        XX, YY, ZZ = F.square(X), F.square(Y), F.square(Z)
        YYYY = F.square(YY)
        S = F.sub(F.sub(F.square(F.add(X, YY)), XX), YYYY)
        S = F.add(S, S)
        M = F.add(F.mul_scalar(XX, 3), F.mul(self.a, F.square(ZZ)))
        T = F.sub(F.square(M), F.add(S, S))
        Y3 = F.sub(F.mul(M, F.sub(S, T)), F.mul_scalar(YYYY, 8))
        return (T, Y3, F.sub(F.sub(F.square(F.add(Y, Z)), YY), ZZ))

    def on_curve(self, xy, b) -> bool:
        F = self.F
        x, y = xy
        rhs = F.add(F.add(F.mul(F.square(x), x), F.mul(self.a, x)), b)
        return F.eq(F.square(y), rhs)

    def point(self, xy):
        """The Jacobian point of an affine one (None: zero)."""
        return self.zero() if xy is None else self.from_affine(*xy)

    def mul_affine(self, xy, k: int):
        """k xy, affine."""
        return self.affine(self.times_scalar(self.point(xy), k))


def _g1_bits(p) -> list:
    x, y = p
    return [y & 1] + [(x >> i) & 1 for i in range(FQ_BITS)]


def _g2_bits(p) -> list:
    x, y = p
    return [y[0] & 1] + [(c >> i) & 1 for c in x for i in range(FQ_BITS)]


def hash_bits(A, B, C, dp) -> list:
    """The bit string of the hash's input (mnt6753.js:645-658)."""
    return _g1_bits(A) + _g2_bits(B) + _g1_bits(C) + _g2_bits(dp)


_B2S_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F,
           0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
_B2S_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0))
_M32 = 0xFFFFFFFF


def _b2s_compress(h, block: bytes, t: int, last: bool) -> None:
    m = [int.from_bytes(block[4 * i:4 * i + 4], "little") for i in range(16)]
    v = list(h) + list(_B2S_IV)
    v[12] ^= t & _M32
    v[13] ^= t >> 32
    if last:
        v[14] ^= _M32

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _M32
        w = v[d] ^ v[a]
        v[d] = (w >> 16 | w << 16) & _M32
        v[c] = (v[c] + v[d]) & _M32
        w = v[b] ^ v[c]
        v[b] = (w >> 12 | w << 20) & _M32
        v[a] = (v[a] + v[b] + y) & _M32
        w = v[d] ^ v[a]
        v[d] = (w >> 8 | w << 24) & _M32
        v[c] = (v[c] + v[d]) & _M32
        w = v[b] ^ v[c]
        v[b] = (w >> 7 | w << 25) & _M32

    for s in _B2S_SIGMA:
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])
    for i in range(8):
        h[i] ^= v[i] ^ v[i + 8]


def blake2s(data: bytes) -> bytes:
    """The unkeyed 32-byte BLAKE2s digest of data (RFC 7693)."""
    h = list(_B2S_IV)
    h[0] ^= 0x01010020
    blocks = [data[k:k + 64] for k in range(0, len(data), 64)] or [b""]
    t = 0
    for k, block in enumerate(blocks):
        t += len(block)
        _b2s_compress(h, block.ljust(64, b"\0"), t, k == len(blocks) - 1)
    return b"".join(x.to_bytes(4, "little") for x in h)


def digest(x: int) -> int:
    """blake2s of the 95 low bytes of x, little-endian, as an integer read
    little-endian (mnt6753.js:766)."""
    return int.from_bytes(blake2s(x.to_bytes(96, "little")[:95]), "little")


class Mnt6753:
    def __init__(self):
        self.q, self.r = Q, R
        self.F1 = Fp(Q)
        self.F3 = F3(self.F1, lambda a: a * NR % Q)
        # v times an F3 element: (a0, a1, a2) -> (11 a2, a0, a1)
        self.F6 = F2(self.F3, lambda a: (a[2] * NR % Q, a[0], a[1]))
        self.G1 = JacobianA(self.F1, A)
        self.G2 = JacobianA(self.F3, (0, 0, A))
        self.b1, self.b2 = B, (B * NR % Q, 0, 0)
        self.g1 = self.G1.from_affine(*G1_GEN)
        self.g2 = self.G2.from_affine(*G2_GEN)
        F6, z3 = self.F6, self.F3.zero()
        w = (z3, self.F3.one())
        self._w_m2 = F6.inv(F6.square(w))
        self._w_m3 = F6.inv(F6.mul(F6.square(w), w))
        # x -> x^q on F6: component k (power k of 11^(1/6): 0, 2, 4 across
        # a0, a1, a2; 1, 3, 5 across b0, b1, b2) times 11^(k (q - 1)/6)
        self._frob = [pow(NR, k * (Q - 1) // 6, Q) for k in range(6)]

    # -- groups ---------------------------------------------------------------

    @functools.cached_property
    def g1_table(self):
        return FixedBase(self.G1, self.g1, self.r.bit_length())

    def g1_mul(self, k: int):
        return self.g1_table.mul(k % self.r)

    def g2_mul(self, k: int):
        return self.G2.times_scalar(self.g2, k % self.r)

    # -- the ate pairing ------------------------------------------------------

    def _f6(self, a):
        """An Fp element in F6."""
        return ((a, 0, 0), self.F3.zero())

    def _line(self, T, Q2, P):
        """The line through T and Q2 (the tangent where they are equal) at
        P, and T + Q2 (None where it is zero); affine over F6, a = 11."""
        F = self.F6
        (xT, yT), (xQ, yQ), (xP, yP) = T, Q2, P
        if F.eq(xT, xQ):
            if F.eq(yT, F.neg(yQ)):
                return F.sub(xP, xT), None
            num = F.add(F.mul_scalar(F.square(xT), 3), self._f6(A))
            den = F.add(yT, yT)
        else:
            num, den = F.sub(yQ, yT), F.sub(xQ, xT)
        lam = F.mul(num, F.inv(den))
        line = F.sub(F.sub(yP, yT), F.mul(lam, F.sub(xP, xT)))
        x3 = F.sub(F.sub(F.square(lam), xT), xQ)
        return line, (x3, F.sub(F.mul(lam, F.sub(xT, x3)), yT))

    def miller_loop(self, p, q2):
        """f_{T,Q}(P) over the ate loop count, p affine in G1, q2 in G2."""
        F = self.F6
        P = (self._f6(p[0]), self._f6(p[1]))
        Qp = (F.mul((q2[0], self.F3.zero()), self._w_m2),
              F.mul((q2[1], self.F3.zero()), self._w_m3))
        T, f = Qp, F.one()
        for bit in bin(ATE_LOOP_COUNT)[3:]:
            line, T = self._line(T, T, P)
            f = F.mul(F.square(f), line)
            if bit == "1":
                line, T = self._line(T, Qp, P)
                f = F.mul(f, line)
        return f

    def frobenius(self, f):
        (a0, a1, a2), (b0, b1, b2) = f
        g = self._frob
        return ((a0, a1 * g[2] % Q, a2 * g[4] % Q),
                (b0 * g[1] % Q, b1 * g[3] % Q, b2 * g[5] % Q))

    def final_exponentiation(self, f):
        """f^((q^3 - 1)(q + 1)(q + w0)): conj(f) / f (f^(q^3) is the
        conjugate over F3), times its Frobenius, then frob(t) t^w0."""
        F = self.F6
        t = F.mul(F.conjugate(f), F.inv(f))
        t = F.mul(self.frobenius(t), t)
        return F.mul(self.frobenius(t), F.exp(t, ATE_LOOP_COUNT))

    def pairing_eq(self, pairs, expected=None) -> bool:
        """prod e(P_i, Q_i) == expected (1 where None) over affine points;
        a pair with a zero point contributes 1."""
        F = self.F6
        acc = F.one()
        for p, q2 in pairs:
            if p is not None and q2 is not None:
                acc = F.mul(acc, self.miller_loop(p, q2))
        return F.eq(self.final_exponentiation(acc),
                    F.one() if expected is None else expected)

    def pairing(self, p, q2):
        return self.final_exponentiation(self.miller_loop(p, q2))

    # -- the Pedersen hash (build_pedersenhash.js) ----------------------------

    @functools.cached_property
    def _pedersen_pairs(self):
        """Window w (3 bits: sel = b0 + 2 b1, sign b2) adds d (16^k B_c)
        with d = +-(sel + 1), k = w mod 188 and c = w div 188 (the
        reference's 188 accumulators folded with 16x between them).
        Windows 2j and 2j + 1 lie in one chunk (188 is even), so together
        they add (d0 + 16 d1) P_j with P_j = 16^(2j mod 188) B_c: row j
        holds m P_j affine for m = 0..68."""
        n = PEDERSEN_CHUNK_SIZE
        G = self.G1
        n_pairs = -(-(VERIFIER_BITS + 2) // 3 // 2)
        ps = []
        for c in range(-(-2 * n_pairs // n)):
            p = G.from_affine(*PEDERSEN_BASES[c])
            for _ in range(n // 2):
                ps.append(G.affine(p))
                for _ in range(8):
                    p = G.double(p)
        ps = ps[:n_pairs]
        rows = [[None, p] for p in ps]
        for m in range(2, 69):
            nxt = add_affine_many([(r[-1], r[1]) for r in rows], Q, A)
            for r, s in zip(rows, nxt):
                r.append(s)
        return rows

    def pedersen_many(self, bit_rows) -> list:
        """The x of the Pedersen hash of each bit string (at most
        VERIFIER_BITS bits; g1m_pedersenHash keeps x alone)."""
        table = self._pedersen_pairs
        terms = []
        for bits in bit_rows:
            if len(bits) > VERIFIER_BITS:
                raise ValueError("bit string longer than the tables")
            n_win = -(-len(bits) // 3)
            b = list(bits) + [0] * (3 * n_win + 3 - len(bits))
            d = [((b[i] | b[i + 1] << 1) + 1) * (1 - 2 * b[i + 2])
                 for i in range(0, 3 * n_win, 3)] + [0]
            row = []
            for j in range(0, n_win, 2):
                m = d[j] + 16 * d[j + 1]
                p = table[j // 2][abs(m)]
                row.append(p if m > 0 else (p[0], -p[1] % Q))
            terms.append(row)
        out = sum_affine_many(terms, Q, A)
        if any(p is None for p in out):
            raise ValueError("a Pedersen hash at the zero point")
        return [p[0] for p in out]

    # -- the group map (build_mnt6753.js:1385-1511) ---------------------------

    @functools.cached_property
    def _tonelli(self):
        s, t = 0, Q - 1
        while t % 2 == 0:
            s, t = s + 1, t // 2
        z = 2
        while pow(z, (Q - 1) // 2, Q) == 1:
            z += 1
        return s, t, pow(z, t, Q)

    def is_square(self, a: int) -> bool:
        return a % Q == 0 or pow(a, (Q - 1) // 2, Q) == 1

    def sqrt(self, a: int) -> int:
        """The square root with an even canonical value (f1m_sqrt negates
        an odd root), Tonelli-Shanks."""
        a %= Q
        if a == 0:
            return 0
        m, t, c = self._tonelli
        u, b = pow(a, (t + 1) // 2, Q), pow(a, t, Q)
        while b != 1:
            i, bb = 0, b
            while bb != 1:
                bb, i = bb * bb % Q, i + 1
            e = pow(c, 1 << (m - i - 1), Q)
            c = e * e % Q
            u, b, m = u * e % Q, b * c % Q, i
        return Q - u if u & 1 else u

    def group_map(self, t: int):
        """A field element to a G1 point: of x = v, -(1 + v), 1 + y^2 the
        first whose right-hand side is a square."""
        t %= Q
        ct = GROUP_MAP_CONIC_C * t % Q
        s = 2 * (ct + GROUP_MAP_PROJ_Z) * pow(ct * t + 1, -1, Q) % Q
        z = (GROUP_MAP_PROJ_Z - s) % Q
        y = (1 - s * t) % Q
        v = (z * pow(y, -1, Q) - pow(2, -1, Q)) % Q
        for x in (v, -(1 + v) % Q, (1 + y * y) % Q):
            rhs = (x * x * x + A * x + B) % Q
            if self.is_square(rhs):
                return (x, self.sqrt(rhs))
        raise ValueError("group map: no candidate")

    def ys_many(self, quads) -> list:
        """Ys of each (A, B, C, dp), affine points: the group map of
        blake2s of the Pedersen hash of their bits."""
        xs = self.pedersen_many([hash_bits(*p) for p in quads])
        return [self.group_map(digest(x)) for x in xs]


@functools.lru_cache(maxsize=1)
def curve() -> Mnt6753:
    return Mnt6753()


# -- the verifier -------------------------------------------------------------

def _f3(e) -> tuple:
    return (int(e["a"]) % Q, int(e["b"]) % Q, int(e["c"]) % Q)


def g1_of(e) -> tuple:
    return (int(e["x"]) % Q, int(e["y"]) % Q)


def g2_of(e) -> tuple:
    return (_f3(e["x"]), _f3(e["y"]))


def f3_json(v) -> dict:
    return {"a": str(v[0]), "b": str(v[1]), "c": str(v[2])}


def g1_json(p) -> dict:
    return {"x": str(p[0]), "y": str(p[1])}


def g2_json(p) -> dict:
    return {"x": f3_json(p[0]), "y": f3_json(p[1])}


def neg(p):
    return None if p is None else (p[0], -p[1] % Q)


def verify_bg(cv: Mnt6753, vk: dict, inputs, proof: dict) -> bool:
    """verifySync: vk_x = query_0 + sum input_i query_(i+1) (each input
    its raw value, as mnt6753.js takes it), e(A, B) = alphaBeta e(vk_x,
    G2) e(C, dp), then Ys from A, B, C and dp and e(Ys, dp) = e(Z,
    delta); every value read from the JSON the program got."""
    query = [g1_of(p) for p in vk["query"]]
    if len(inputs) + 1 != len(query):
        return False
    ab = (_f3(vk["alphaBeta"]["a"]), _f3(vk["alphaBeta"]["b"]))
    delta = g2_of(vk["delta"])
    a, b, c = g1_of(proof["a"]), g2_of(proof["b"]), g1_of(proof["c"])
    dp, z = g2_of(proof["deltaPrime"]), g1_of(proof["z"])
    G1 = cv.G1
    vk_x = G1.point(query[0])
    for v, p in zip(inputs, query[1:]):
        vk_x = G1.add(vk_x, G1.times_scalar(G1.point(p), int(v)))
    g2 = cv.G2.affine(cv.g2)
    if not cv.pairing_eq([(a, b), (neg(G1.affine(vk_x)), g2), (neg(c), dp)],
                         expected=ab):
        return False
    ys = cv.ys_many([(a, b, c, dp)])[0]
    return cv.pairing_eq([(ys, dp), (neg(z), delta)])


@dataclasses.dataclass
class Trapdoor:
    """The key's discrete logs: query_i = qs[i] G1, alphaBeta = e(G1,
    G2)^k, delta = t G2."""
    qs: list
    k: int
    t: int

    @classmethod
    def draw(cls, rng, n_inputs: int) -> "Trapdoor":
        return cls([rng.randrange(1, R) for _ in range(n_inputs + 1)],
                   rng.randrange(1, R), rng.randrange(1, R))


def vk_json(cv: Mnt6753, td: Trapdoor) -> dict:
    """The key in the JSON layout verifySync reads."""
    G1, G2 = cv.G1, cv.G2
    ab = cv.F6.exp(cv.pairing(G1.affine(cv.g1), G2.affine(cv.g2)), td.k)
    return {"query": [g1_json(G1.affine(cv.g1_mul(q))) for q in td.qs],
            "alphaBeta": {"a": f3_json(ab[0]), "b": f3_json(ab[1])},
            "delta": g2_json(G2.affine(cv.g2_mul(td.t)))}


def verify_exponent(cv: Mnt6753, td: Trapdoor, values, logs, points,
                    ys=None, hash_check: bool = True) -> bool:
    """Both equations for a proof whose discrete logs are known: logs (a,
    b, c, s) with A = a G1, B = b G2, C = c G1 and dp = s delta (so d = s
    t); points (A, B, C, dp, Z) affine, as the proof holds them.  The
    first in the exponent, a b = k + x + c d (mod r); the second as Z = (d
    / t) Ys = s Ys, Ys worked out from the lane's own A, B, C and dp (ys:
    a function of those four, cv.ys_many's by default)."""
    if len(values) + 1 != len(td.qs):
        return False
    a, b, c, s = logs
    x = td.qs[0] + sum(v * q for v, q in zip(values, td.qs[1:]))
    if (a * b - td.k - x - c * s * td.t) % R:
        return False
    if not hash_check:
        return True
    quad = tuple(points[:4])
    y = ys(quad) if ys is not None else cv.ys_many([quad])[0]
    return points[4] == cv.G1.mul_affine(y, s)
